"""The port's kernel twins against the JAX package's Pallas kernels run in
interpret mode, on `_random_tree` inputs (copied from tests/test_pallas.py).

* `walk_ref` is bit-equal to `PK.walk` and to `search._walk`.
* `node_actions_multi_ref` equals `PK.node_actions_multi` draw for draw at
  (n_iters, accel) = (16, False) and (6, True). The exp and the lane sums are
  computed by other code than XLA's, so the solved probs agree only to float32
  roundoff; equality of the draws holds because on these seeds no rand lies
  within 1e-6 of a CDF boundary, which each case checks.

The CUDA kernels themselves are held against these twins on the card in
tests/test_torch_kernels_cuda.py, which imports no JAX.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.mcts import pallas_kernels as PK
from boardlaw_tpu_torch.mcts import kernels

torch.set_num_threads(2)


def _random_tree(rng, B, T, A, Sn=2, c_puct=1.0):
    children = np.full((B, T, A), -1, np.int32)
    parents = np.full((B, T), -1, np.int32)
    relation = np.full((B, T), -1, np.int32)
    seats = rng.integers(0, Sn, (B, T)).astype(np.int32)
    terminal = np.zeros((B, T), bool)
    for b in range(B):
        for c in range(1, T):
            p = rng.integers(0, c)
            free = np.flatnonzero(children[b, p] == -1)
            if len(free) == 0:
                continue
            a = rng.choice(free)
            children[b, p, a] = c
            parents[b, c] = p
            relation[b, c] = a
            terminal[b, c] = rng.random() < 0.15

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
    from boardlaw_tpu_torch.mcts import search as TS
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



def test_cuda_wrappers_refuse_bad_inputs():
    # checks run before any launch, so they are testable without a card
    with pytest.raises(ValueError):
        kernels._check_rows(torch.zeros((2, 3, 4)), "x", torch.float32, 2, 3, 4)
