"""The port's kernel twins against the JAX package's Pallas kernels run in
interpret mode, on `_random_tree` inputs (copied from tests/test_pallas.py),
held in the port's storage types (f32 logits, bf16 n_edge, int8 children).

* `walk_ref` is bit-equal to `PK.walk` and to `search._walk`, also on the
  (K,B,R) view of a (B,K,R) buffer; on every sampler route `simulate_multi`
  hands `walk` views of the sampler's own outputs, with no copy between.
* `node_actions_multi_ref` equals `PK.node_actions_multi` draw for draw at
  (n_iters, accel) = (16, False) and (6, True). The exp and the lane sums are
  computed by other code than XLA's, so the solved probs agree only to float32
  roundoff; equality of the draws holds because on these seeds no rand lies
  within 1e-6 of a CDF boundary, which each case checks.
* The K=1 twins: `search.node_actions` equals `S.node_actions` (whose XLA
  sampler sums with `jnp.cumsum`) and `PK.node_actions` (the log-shift sum)
  draw for draw, under the same boundary check; `search.descend_reference`
  equals `S.descend` and `PK.descend`; `search.backup`, the twin of both
  backup kernels, equals `S.backup`, `PK.backup` and `PK.backup_dense`: n
  exact, w/n_edge/w_edge to atol 1e-5, also at three seats (`PK.backup`) and
  on chains 36 levels deep with terminal nodes on the path (both);
  `search.backup(..., edge="dense")`, the twin of `backup_dense`, equals
  `PK.backup_dense` at one and at three seats, where its edge value (seat
  S-1's at a seat-1 parent) is not the 'delta' rule's.
* The split K>1 twins: `solve_probs_ref` equals `PK.solve_probs` in both
  output modes to rtol 1e-5, atol 1e-7; `sample_children_multi_ref` equals
  `PK.sample_children_multi` bit for bit on the same probs; the 'matmul'
  sampler equals the 'shift' one (and JAX's 'matmul') on dyadic probs,
  where both sums are exact; `search.backup_paths` equals JAX's
  `backup_paths` on the inputs of a real pass (n/n_edge exact, w/w_edge to
  atol 1e-5).

The CUDA kernels themselves are held against these twins on the card in
tests/test_torch_kernels_cuda.py, which imports no JAX.
"""
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.mcts import pallas_kernels as PK
from boardlaw_tpu_torch.mcts import kernels, search as TS
from test_torch_search import _models, _port_tree, _worlds

torch.set_num_threads(2)


def _random_tree(rng, B, T, A, Sn=2, c_puct=1.0, chain=False):
    """With `chain`, every env is one chain (node c's parent c-1) with a
    terminal node at T // 2."""
    children = np.full((B, T, A), -1, np.int32)
    parents = np.full((B, T), -1, np.int32)
    relation = np.full((B, T), -1, np.int32)
    seats = rng.integers(0, Sn, (B, T)).astype(np.int32)
    terminal = np.zeros((B, T), bool)
    for b in range(B):
        for c in range(1, T):
            p = c - 1 if chain else rng.integers(0, c)
            free = np.flatnonzero(children[b, p] == -1)
            if len(free) == 0:
                continue
            a = rng.choice(free)
            children[b, p, a] = c
            parents[b, c] = p
            relation[b, c] = a
            terminal[b, c] = rng.random() < 0.15
    if chain:
        terminal[:, T // 2] = True

    logits = rng.normal(0, 1, (B, T, A)).astype(np.float32)
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    n = rng.integers(1, 20, (B, T)).astype(np.int32)
    w = rng.normal(0, 2, (B, T, Sn)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, Sn)).astype(np.float32)
    rewards = rng.normal(0, 0.5, (B, T, Sn)).astype(np.float32)

    n_edge = np.zeros((B, T, A), np.float32)
    w_edge = np.zeros((B, T, A), np.float32)
    for b in range(B):
        for t in range(T):
            for a in range(A):
                c = children[b, t, a]
                if c > -1:
                    n_edge[b, t, a] = n[b, c]
                    w_edge[b, t, a] = w[b, c, seats[b, t]]

    return S.Tree(
        children=jnp.asarray(children), parents=jnp.asarray(parents),
        relation=jnp.asarray(relation), worlds=None,
        seats=jnp.asarray(seats), terminal=jnp.asarray(terminal),
        rewards=jnp.asarray(rewards), logits=jnp.asarray(logits),
        v=jnp.asarray(v), n=jnp.asarray(n), w=jnp.asarray(w),
        n_edge=jnp.asarray(n_edge), w_edge=jnp.asarray(w_edge),
        c_puct=jnp.full((B,), c_puct, jnp.float32), sim=jnp.array(T, jnp.int32),
    )


def _t(x, dtype=None):
    out = torch.tensor(np.asarray(x))
    return out if dtype is None else out.to(dtype)


def _port_inputs(tree):
    """The JAX tree's solve inputs in the port's storage types."""
    lo, hi = S._q_bounds(tree)
    return dict(
        logits=_t(tree.logits, torch.float32),
        n_edge=_t(tree.n_edge, torch.bfloat16),
        w_edge=_t(tree.w_edge, torch.float32),
        children=_t(tree.children, torch.int8),
        c_puct=_t(tree.c_puct, torch.float32),
        q_bounds=torch.tensor([float(lo), float(hi)], dtype=torch.float32),
    )


def _min_boundary_gap(tree, qb, rands_kbt, n_iters, accel):
    probs = np.asarray(S.node_probs(tree, qb, n_iters=n_iters, accel=accel), np.float64)
    cum = np.cumsum(probs, -1)
    r = np.asarray(rands_kbt, np.float64)[..., None]  # (K,B,T,1)
    return np.abs(cum[None] - r).min()


def _walk_inputs(seed, K):
    rng = np.random.default_rng(seed)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (K, B, T))
    probs = S.node_probs(tree, S._q_bounds(tree))
    acts, nxt = S._sample_children_multi(tree, probs, rands, cum_mode="shift")
    return tree, np.asarray(acts).reshape(K * B, T), np.asarray(nxt).reshape(K * B, T)


@pytest.mark.parametrize("seed", [3, 4])
def test_walk_ref_matches_pallas(seed):
    tree, acts, nxt = _walk_inputs(seed, K=1)
    jp = PK.walk(tree.terminal, jnp.asarray(acts), jnp.asarray(nxt), block_envs=8, interpret=True)
    tp = kernels.walk(_t(tree.terminal), _t(acts), _t(nxt))  # CPU tensors: the twin
    for j, t in zip(jp, tp):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("max_levels", [None, 3])
def test_walk_ref_folded_k_matches_xla(max_levels):
    # K walks folded into rows: row r reads env r % B's terminal flags
    K = 4
    tree, acts, nxt = _walk_inputs(5, K=K)
    term = jnp.broadcast_to(tree.terminal[None], (K,) + tree.terminal.shape).reshape(acts.shape)
    halt = S._halt_of(S.Tree(**{**tree.__dict__, "terminal": term}), jnp.asarray(nxt))
    jp = S._walk(jnp.asarray(acts), jnp.asarray(nxt), halt, term[:, 0], max_levels=max_levels)
    tp = kernels.walk_ref(_t(tree.terminal), _t(acts), _t(nxt), max_levels=max_levels)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if max_levels is None:
        pp = PK.walk(term, jnp.asarray(acts), jnp.asarray(nxt), block_envs=8, interpret=True)
        for j, t in zip(pp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _sampler_view(x, K):
    """(K*B, T) rows as the search hands them to `walk`: the (K,B,T) view of
    a (B,K,T) buffer, as the sampler kernels return it."""
    B = x.shape[0] // K
    buf = _t(x).reshape(K, B, -1).permute(1, 0, 2).contiguous()  # (B,K,T)
    return buf.permute(1, 0, 2)


@pytest.mark.parametrize("max_levels", [None, 3])
def test_walk_ref_on_sampler_view_matches_xla_and_pallas(max_levels):
    K = 4
    tree, acts, nxt = _walk_inputs(5, K=K)
    term = jnp.broadcast_to(tree.terminal[None], (K,) + tree.terminal.shape).reshape(acts.shape)
    halt = S._halt_of(S.Tree(**{**tree.__dict__, "terminal": term}), jnp.asarray(nxt))
    jp = S._walk(jnp.asarray(acts), jnp.asarray(nxt), halt, term[:, 0], max_levels=max_levels)
    va, vn = _sampler_view(acts, K), _sampler_view(nxt, K)
    assert not va.is_contiguous() and va.stride() == (12, 4 * 12, 1)
    tp = kernels.walk(_t(tree.terminal), va, vn, max_levels=max_levels)  # the twin on the CPU
    for j, t in zip(jp, tp):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if max_levels is None:
        pp = PK.walk(term, jnp.asarray(acts), jnp.asarray(nxt), block_envs=8, interpret=True)
        for j, t in zip(pp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("route", [
    dict(solve_kernel="fused"), dict(solve_kernel="probs", sample_kernel=True),
    dict(solve_kernel="alpha"), dict(solve_kernel="ops", sample_kernel=True),
    dict(solve_kernel="ops"), dict(solve_kernel="ops", warm_solve=True),
], ids=["fused", "probs+sampler", "alpha+torch", "ops+sampler", "ops+torch", "warm"])
def test_simulate_multi_hands_walk_the_sampler_buffers(monkeypatch, route):
    # every pass's walk gets (K,B,R) views of the sampler's own outputs
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex as thex
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    sampled, walked = [], []

    def spy(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            sampled.append(out[:2])
            return out
        return wrapped

    monkeypatch.setattr(kernels, "node_actions_multi", spy(kernels.node_actions_multi))
    monkeypatch.setattr(kernels, "sample_children_multi", spy(kernels.sample_children_multi))
    monkeypatch.setattr(TS, "_sample_children_multi", spy(TS._sample_children_multi))
    walk = kernels.walk

    def walk_spy(terminal, acts, nxt, max_levels=None):
        # the sampler that ran last is the one whose outputs the pass uses
        walked.append((acts, nxt, sampled[-1]))
        return walk(terminal, acts, nxt, max_levels)

    monkeypatch.setattr(kernels, "walk", walk_spy)
    B, K = 4, 4
    cfg = TS.MCTSConfig(n_nodes=13, leaves_per_pass=K, **route)
    model = train.build_model(train.make_config(5, 16, 1, n_envs=B), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    tree = TS.mcts(thex.Hex.initial(B, 5, device="cpu"), make_eval_fn(model), Draws(0, "cpu"), cfg)
    assert len(walked) == cfg.n_passes and (tree.n[:, 0] == 2 * K * cfg.n_passes).all()
    for acts, nxt, out in walked:
        assert acts.shape == nxt.shape == (K, B, TS.tree_size(cfg))
        for x, o in zip((acts, nxt), out):
            assert x.untyped_storage().data_ptr() == o.untyped_storage().data_ptr()
            assert x.data_ptr() == o.data_ptr() and x.numel() == o.numel()


@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [
    (0, 1.0, 16, False), (2, 0.0625, 16, False), (9, 1.0, 6, True), (2, 0.0625, 6, True)])
def test_node_actions_multi_ref_matches_pallas(seed, c_puct, n_iters, accel):
    rng = np.random.default_rng(seed)
    B, T, A, K = 16, 12, 7, 4
    tree = _random_tree(rng, B, T, A, c_puct=c_puct)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (K, B, T))
    qb = S._q_bounds(tree)
    assert _min_boundary_gap(tree, qb, rands, n_iters, accel) > 1e-6

    ja, jc = PK.node_actions_multi(tree, jnp.moveaxis(rands, 0, 1), qb, block_envs=8,
                                   interpret=True, n_iters=n_iters, accel=accel)
    inp = _port_inputs(tree)
    ta, tc, alpha = kernels.node_actions_multi(
        rands=_t(jnp.moveaxis(rands, 0, 1)), n_iters=n_iters, accel=accel, return_alpha=True, **inp)
    assert ta.shape == (B, K, T) and ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    # the solve itself: the port's probs against the JAX package's node_probs
    jprobs = np.asarray(S.node_probs(tree, qb, n_iters=n_iters, accel=accel))
    tprobs = TS.node_probs(inp["logits"], inp["n_edge"], inp["w_edge"], inp["c_puct"],
                           inp["q_bounds"], n_iters=n_iters, accel=accel)
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=1e-5, atol=1e-7)
    assert alpha.shape == (B, T) and torch.isfinite(alpha).all()


def test_node_actions_multi_ref_on_row_slice():
    # the grow passes hand the kernels a leading slice of the node axis
    rng = np.random.default_rng(1)
    B, T, A, K = 8, 12, 7, 4
    tree = _random_tree(rng, B, T, A)
    inp = _port_inputs(tree)
    rands = torch.rand((B, K, 5), generator=torch.Generator().manual_seed(0))
    sliced = {k: (v[:, :5] if v.dim() == 3 else v) for k, v in inp.items()}
    full = {k: (v[:, :5].contiguous() if v.dim() == 3 else v) for k, v in inp.items()}
    for a, b in zip(kernels.node_actions_multi(rands=rands, **sliced),
                    kernels.node_actions_multi(rands=rands, **full)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (1, 0.0625)])
def test_node_actions_twin_matches_xla_and_pallas(seed, c_puct):
    rng = np.random.default_rng(seed)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A, c_puct=c_puct)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (B, T))
    qb = S._q_bounds(tree)
    assert _min_boundary_gap(tree, qb, rands[None], 16, False) > 1e-6

    xa, xc = S.node_actions(tree, rands, qb)
    pa, pc = PK.node_actions(tree, rands, qb, block_envs=8, interpret=True)
    ta, tc = kernels.node_actions(rands=_t(rands), **_port_inputs(tree))  # CPU: the twin
    assert ta.dtype == tc.dtype == torch.int32 and ta.shape == (B, T)
    for j in (xa, pa):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(j))
    for j in (xc, pc):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(j))
    # the debug alpha: the same draws, and the roots of the 16 Newton steps
    inp = _port_inputs(tree)
    aa, ac, alpha = kernels.node_actions(rands=_t(rands), return_alpha=True, **inp)
    assert torch.equal(aa, ta) and torch.equal(ac, tc)
    ref = kernels.solve_probs_ref(*(inp[k] for k in ("logits", "n_edge", "w_edge", "c_puct",
                                                     "q_bounds")),
                                  n_iters=16, accel=False, out="alpha")
    assert torch.equal(alpha, ref)


@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (1, 0.0625), (2, 10.0)])
def test_descend_twin_matches_xla_and_pallas(seed, c_puct):
    rng = np.random.default_rng(seed)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A, c_puct=c_puct)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (B, T))
    assert _min_boundary_gap(tree, S._q_bounds(tree), rands[None], 16, False) > 1e-6

    xp, xa = S.descend(tree, rands)
    pp, pa = PK.descend(tree, rands, block_envs=8, interpret=True)
    ttree = _port_tree(tree)
    n0 = kernels.launches["descend"]
    tp, ta = kernels.descend(ttree, _t(rands))  # CPU: search.descend_reference
    assert kernels.launches["descend"] == n0
    for jp, ja in ((xp, xa), (pp, pa)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # the default route (node_actions + walk twins) gives the same walk
    dp, da = TS.descend(ttree, _t(rands))
    assert torch.equal(dp, tp) and torch.equal(da, ta)


@pytest.mark.parametrize("npv", [1, 2])
@pytest.mark.parametrize("variant", ["delta", "dense"])
def test_backup_twin_matches_xla_and_pallas(npv, variant):
    rng = np.random.default_rng(3 if variant == "delta" else 5)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A)
    leaves = jnp.asarray(rng.integers(0, T, B), jnp.int32)

    pallas = PK.backup if variant == "delta" else PK.backup_dense
    outs = [S.backup(tree, leaves, npv), pallas(tree, leaves, npv, block_envs=8, interpret=True)]
    wrapper = kernels.backup if variant == "delta" else kernels.backup_dense
    ttree = wrapper(_port_tree(tree), _t(leaves), npv)  # CPU: search.backup, in place
    assert ttree.n.dtype == torch.int32 and ttree.n_edge.dtype == torch.bfloat16
    for out in outs:
        np.testing.assert_array_equal(ttree.n.numpy(), np.asarray(out.n))
        for name in ("w", "n_edge", "w_edge"):
            np.testing.assert_allclose(getattr(ttree, name).float().numpy(),
                                       np.asarray(getattr(out, name), np.float32),
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("npv", [1, 2])
@pytest.mark.parametrize("case", ["three seats", "chain"])
def test_backup_twin_matches_pallas_three_seats_and_chains(case, npv):
    # three seats: the 'delta' edge value at the parent's clamped seat; a
    # chain: every leaf 36 levels deep (one env's at the root), a terminal
    # node on each path, past it only the rewards reach the root
    rng = np.random.default_rng(7)
    if case == "three seats":
        B, T, A = 16, 12, 7
        tree = _random_tree(rng, B, T, A, Sn=3)
        leaves = rng.integers(0, T, B)
    else:
        B, T, A = 8, 37, 7
        tree = _random_tree(rng, B, T, A, chain=True)
        leaves = np.full(B, T - 1)
        leaves[1] = 0
    leaves = jnp.asarray(leaves, jnp.int32)

    outs = [S.backup(tree, leaves, npv), PK.backup(tree, leaves, npv, block_envs=8, interpret=True)]
    if case == "chain":
        outs.append(PK.backup_dense(tree, leaves, npv, block_envs=8, interpret=True))
    ttree = kernels.backup(_port_tree(tree), _t(leaves), npv)  # CPU: search.backup, in place
    if case == "chain":  # each deep path visits all T nodes, the root leaf one
        assert int((ttree.n - _t(tree.n)).sum()) == npv * (T * (B - 1) + 1)
    for out in outs:
        np.testing.assert_array_equal(ttree.n.numpy(), np.asarray(out.n))
        for name in ("w", "n_edge", "w_edge"):
            np.testing.assert_allclose(getattr(ttree, name).float().numpy(),
                                       np.asarray(getattr(out, name), np.float32),
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("npv", [1, 2])
@pytest.mark.parametrize("n_seats", [1, 3])
def test_backup_dense_twin_matches_pallas_one_and_three_seats(n_seats, npv):
    # the Pallas kernel's edge value is v[0] at a seat-0 parent, else
    # v[S-1]: at three seats that is not the parent's own seat 1, which the
    # 'delta' rule reads; one seat is the planted-value games' tree
    rng = np.random.default_rng(11 + n_seats)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A, Sn=n_seats)
    leaves = jnp.asarray(rng.integers(0, T, B), jnp.int32)
    out = PK.backup_dense(tree, leaves, npv, block_envs=8, interpret=True)
    ttree = kernels.backup_dense(_port_tree(tree), _t(leaves), npv)  # CPU: the dense twin
    np.testing.assert_array_equal(ttree.n.numpy(), np.asarray(out.n))
    for name in ("w", "n_edge", "w_edge"):
        np.testing.assert_allclose(getattr(ttree, name).float().numpy(),
                                   np.asarray(getattr(out, name), np.float32),
                                   atol=1e-5, err_msg=name)
    delta = TS.backup(_port_tree(tree), _t(leaves), npv)
    if n_seats == 3:  # seat-1 parents take another value under the two rules
        assert not torch.equal(delta.w_edge, ttree.w_edge)
    else:
        assert torch.equal(delta.w_edge, ttree.w_edge)


def test_cuda_wrappers_refuse_bad_inputs():
    # checks run before any launch, so they are testable without a card
    with pytest.raises(ValueError):
        kernels._check_rows(torch.zeros((2, 3, 4)), "x", torch.float32, 2, 3, 4)
    with pytest.raises(ValueError):
        kernels._check_node(torch.zeros((2, 3)), "x", torch.float32, (2, 3))
    # backup_dense reads the edge value at seat 0 or S-1: 1 to 4 seats
    rng = np.random.default_rng(0)
    five = _port_tree(_random_tree(rng, 2, 4, 3, Sn=5))
    with pytest.raises(ValueError, match="1 to 4 seats"):
        kernels.backup_dense(five, torch.zeros((2,), dtype=torch.int32), 1)
    # the backups check every tensor they read or write, storage type and
    # shape before the device
    tree = _port_tree(_random_tree(rng, 2, 4, 3))
    leaves = torch.zeros((2,), dtype=torch.int32)
    for name, bad in (("n", tree.n.long()), ("w", tree.w.double()),
                      ("n_edge", tree.n_edge.half()), ("w_edge", tree.w_edge[:, :, :2]),
                      ("relation", tree.relation.long()), ("seats", tree.seats[:1]),
                      ("parents", tree.parents.t())):
        with pytest.raises(ValueError, match=f"^{name} must be"):
            kernels._check_backup(replace(tree, **{name: bad}), leaves, 1)
    with pytest.raises(ValueError, match="^leaves must be"):
        kernels._check_backup(tree, leaves.long(), 1)
    with pytest.raises(ValueError, match="^n_per_visit must be whole"):
        kernels._check_backup(tree, leaves, 1.5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # a good tree, on the CPU
        kernels._check_backup(tree, leaves, 2)


@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [(0, 1.0, 6, True), (2, 0.0625, 16, False)])
def test_solve_probs_twin_matches_pallas(seed, c_puct, n_iters, accel):
    rng = np.random.default_rng(seed)
    B, T, A = 16, 12, 7
    tree = _random_tree(rng, B, T, A, c_puct=c_puct)
    qb = S._q_bounds(tree)
    inp = _port_inputs(tree)
    del inp["children"]
    for out in ("probs", "alpha"):
        jres = PK.solve_probs(tree, qb, n_iters=n_iters, accel=accel, interpret=True, out=out)
        tres = kernels.solve_probs(n_iters=n_iters, accel=accel, out=out, **inp)  # CPU: the twin
        assert tres.shape == ((B, T) if out == "alpha" else (B, T, A))
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-5, atol=1e-7,
                                   err_msg=out)
    # the alpha route's probs, evaluated at the roots, are the solve's probs
    probs = TS.node_probs(*(inp[k] for k in ("logits", "n_edge", "w_edge", "c_puct", "q_bounds")),
                          fixed_alpha=tres)
    np.testing.assert_allclose(probs.numpy(), np.asarray(S.node_probs(tree, qb, n_iters=n_iters,
                                                                      accel=accel)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_children_twin_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    B, T, A, K = 16, 12, 7, 4
    tree = _random_tree(rng, B, T, A)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (B, K, T))
    probs = S.node_probs(tree, S._q_bounds(tree))
    ja, jc = PK.sample_children_multi(probs, tree.children, rands, block_envs=8, interpret=True)
    n0 = kernels.launches["sample_children_multi"]
    ta, tc = kernels.sample_children_multi(_t(probs), _t(tree.children, torch.int8), _t(rands))
    assert kernels.launches["sample_children_multi"] == n0
    assert ta.dtype == tc.dtype == torch.int32 and ta.shape == (B, K, T)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_sampler_matmul_matches_shift_on_dyadic_probs():
    # tests/test_mcts.py's case: with exactly representable probs both prefix
    # sums are exact, so the two formulations agree bit for bit, also for
    # rand 0 on a zero-prob lane 0, a rand on a boundary, a rand past an
    # unnormalized total and an all-zero row
    from types import SimpleNamespace

    B, T, A, K = 4, 2, 8, 5
    base = np.zeros((B, T, A), np.float32)
    base[..., :] = [0.0, 0.25, 0.0, 0.125, 0.5, 0.125, 0.0, 0.0]
    base[1] = 0.0
    base[2, :, :] = [0.5, 0.25, 0.125, 0.0625, 0.03125, 0.0, 0.0, 0.0]
    base[3, :, :] = [0.0, 0.5, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0]
    rng = np.random.default_rng(0)
    children = rng.integers(-1, T, size=(B, T, A)).astype(np.int8)
    rands = np.broadcast_to(np.array([0.0, 0.25, 0.5, 0.9375, 0.999], np.float32)[:, None, None],
                            (K, B, T)).copy()
    rands[4] = rng.uniform(size=(B, T))
    outs = {mode: TS._sample_children_multi(torch.tensor(children), torch.tensor(base),
                                            torch.tensor(rands), cum_mode=mode)
            for mode in ("matmul", "shift")}
    ja, jc = S._sample_children_multi(SimpleNamespace(children=jnp.asarray(children)),
                                      jnp.asarray(base), jnp.asarray(rands), cum_mode="matmul")
    for a, c in outs.values():
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert (outs["shift"][0][:, 1] == -1).all() and (outs["shift"][1][:, 1] == 0).all()


def test_backup_paths_matches_jax():
    # the einsum spec on the exact inputs of a real third pass
    seed, B = 5, 8
    jeval, _ = _models(seed=seed)
    jworld = _worlds(5, B, 6, seed)
    cfg = S.MCTSConfig(n_nodes=13, leaves_per_pass=4, use_pallas=False, pallas_walk=False,
                       backup_mode="einsum")

    def third_pass(w, key):
        k0, k1, k2, k3 = jax.random.split(key, 4)
        tree = S.initialize(S.build(w, cfg), jeval(w, None), k0, cfg, w.valid)
        tree = S.simulate_multi(S.simulate_multi(tree, jeval, k1, cfg), jeval, k2, cfg)
        return S.simulate_multi(tree, jeval, k3, cfg, return_backup_inputs=True)

    jt, paths, acts, leaves, npv = jax.jit(third_pass)(jworld, jax.random.PRNGKey(seed))
    npv = int(npv)
    ref = jax.jit(S.backup_paths, static_argnums=4)(jt, paths, acts, leaves, npv)
    tt = TS.backup_paths(_port_tree(jt), _t(paths), _t(acts), _t(leaves), npv)
    assert int((np.asarray(paths) >= 0).sum(-1).max()) >= 2  # paths below the root's children
    np.testing.assert_array_equal(tt.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(ref.n_edge, np.float32))
    for name in ("w", "w_edge"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, err_msg=name)
