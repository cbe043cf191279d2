"""The CUDA kernels against their plain twins, on the card.

Every case here needs a CUDA card and skips without one. The file imports
torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

`walk` is pure integer logic and must be bit-equal, in each of its designs,
on (N,R) rows and on the (K,B,R) view of a (B,K,R) buffer. `node_actions_multi`
and `node_actions` sum their lanes in another order than the twins, so the
solved alpha agrees to rtol 1e-5; the draws are equal, since no rand lies
within 1e-6 of a CDF boundary (the cases redraw any within 1e-5 and check).
The row cases run at A = 9, 25, 36, 49, 81 and 121 (boards 3 to 11), so
every lane layout of `kernels.row_layout` runs.
`descend` shares the row code of `node_actions` and must equal
`node_actions` + `walk` on the card exactly. `backup` and `backup_dense`
make the twin's adds in the twin's order: n, w, n_edge and w_edge equal it
bit for bit, at T = 12, 37, 64 and 65, on chains T-1 levels deep, from the
root, at three seats (both) and at one seat (`backup_dense`, whose twin is
`search.backup(..., edge="dense")`). The K=1 search backs up in the
`backup` kernel, one launch a simulation, and builds the tree that it
builds with its twin `search.backup` in the kernel's place, bit for bit.
`backup_prefix` backs up a K=8 pass: at every pass of real grow searches
(64 nodes, int8 children and bf16 counts; 512 nodes, int32 and f32; f32
and bf16 tree logits; `backup_n` 'seats' and 'visits'), with duplicate
and terminal leaves and paths below the root's children, n, w, n_edge and
w_edge equal the twin `search.backup_paths_prefix` run on the card (its
index_put_'s association) and a second launch on the same input, bit for
bit; against the twin on the CPU (deterministic mode) n, w and n_edge are
bit-equal and w_edge within what two orders of adding a pass's terms may
differ by. A K=8 search launches it once a pass, and two searches of one
seed build the same tree bit for bit.
`solve_probs` runs the solve of `node_actions_multi`: its
probs agree with the twin's to rtol 1e-5 and its alpha is
`node_actions_multi`'s, bit for bit; `sample_children_multi` adds in the
twin's order and is bit-equal to it, and the split pair draws what
`node_actions_multi` draws.

The bf16 instantiations of the four kernels that read the logits
(`node_actions_multi`, `node_actions`, `descend`, `solve_probs`) run on
bf16 logits in place: each is bit-equal to the f32 kernel on the logits'
f32 copy (a bf16 logit widens to f32 exactly), agrees with its twin by the
rules above (`solve_probs`: alpha to rtol 1e-5 and the probs to rtol 1e-5
of the twin's formula at the kernel's alpha, as chip_smoke.py phase 3b
holds them; on one row of one case the solved probs differ from the twin's
own solve by 1.6e-5 relative, where alpha - q is small), and counts its
launch under its name's `.bf16` entry of `kernels.launches`, not the f32
one.

The wide tree (`search.tree_dtypes`: int32 children with bf16 counts at
T = 128, int32 with f32 counts above) has instantiations of its own in the
seven kernels that read children or counts, counted under `.mixed` and
`.wide` in `kernels.launches`: each agrees with its twin by the rules above on trees of
128, 300 and 513 slots, whose child ids pass 127 and 256 (on bf16 logits,
`node_actions_multi`'s alpha is held bit for bit against the f32
instantiation on the logits' f32 copy, and its draws against the twin: on
one row of the T = 128 tree the twin's alpha differs by 3.5e-5 relative, a
root where the solve is ill-conditioned); at T = 128 the
mixed instantiation equals the compact one on int8 copies of the ids, bit
for bit. `walk` runs each design at the wide trees' shapes (T = 513 with
L = 65 at K = 8, T = L = 256 at K = 1), and a dtype with no instantiation
raises.
"""
import contextlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import kernels, search

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_search_tree(seed, B, T, A, c_puct=1.0, n_seats=2, chains=False,
                        dtypes=(torch.int8, torch.bfloat16)):
    """A random port tree (the tree of tests/test_pallas.py `_random_tree`,
    in numpy) in the port's storage types, children and n_edge in `dtypes`,
    with sim = T. With `chains`, each even env is one chain (node c's parent
    c-1) with a terminal node at T // 2."""
    rng = np.random.default_rng(seed)
    children = np.full((B, T, A), -1, np.int32)
    parents = np.full((B, T), -1, np.int32)
    relation = np.full((B, T), -1, np.int32)
    seats = rng.integers(0, n_seats, (B, T))
    terminal = np.zeros((B, T), bool)
    for b in range(B):
        for c in range(1, T):
            p = c - 1 if chains and b % 2 == 0 else rng.integers(0, c)
            free = np.flatnonzero(children[b, p] == -1)
            if len(free) == 0:
                continue
            a = rng.choice(free)
            children[b, p, a] = c
            parents[b, c], relation[b, c] = p, a
            terminal[b, c] = rng.random() < 0.15
        if chains and b % 2 == 0:
            terminal[b, T // 2] = True
    logits = rng.normal(0, 1, (B, T, A)).astype(np.float32)
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    n = rng.integers(1, 20, (B, T))
    w = rng.normal(0, 2, (B, T, n_seats)).astype(np.float32)
    expanded = children >= 0
    c = np.where(expanded, children, 0)
    bb = np.arange(B)[:, None, None]
    n_edge = np.where(expanded, n[bb, c], 0).astype(np.float32)
    w_edge = np.where(expanded, w[bb, c, seats[:, :, None]], 0).astype(np.float32)
    v = rng.normal(0, 1, (B, T, n_seats)).astype(np.float32)
    rewards = rng.normal(0, 0.5, (B, T, n_seats)).astype(np.float32)
    t = torch.tensor
    return search.Tree(
        children=t(children).to(dtypes[0]), parents=t(parents), relation=t(relation),
        worlds=None, seats=t(seats).to(torch.int32), terminal=t(terminal), rewards=t(rewards),
        logits=t(logits), v=t(v), n=t(n).to(torch.int32), w=t(w),
        n_edge=t(n_edge).to(dtypes[1]), w_edge=t(w_edge),
        c_puct=torch.full((B,), c_puct, dtype=torch.float32), sim=T, prew=None)


def _random_tree(seed, B, T, A, c_puct=1.0, dtypes=(torch.int8, torch.bfloat16)):
    """A random tree's solve inputs in the port's storage types, and its
    terminal flags."""
    tree = _random_search_tree(seed, B, T, A, c_puct, dtypes=dtypes)
    return dict(logits=tree.logits, n_edge=tree.n_edge, w_edge=tree.w_edge,
                children=tree.children, c_puct=tree.c_puct,
                q_bounds=search._q_bounds(tree)), tree.terminal


def _tree_to(tree, dev):
    """A copy of the tree on `dev` (a copy also on its own device: the
    backups update in place)."""
    return search.Tree(**{k: (v.to(dev, copy=True) if torch.is_tensor(v) else v)
                          for k, v in tree.__dict__.items()})


def _to(inp, dev):
    return {k: v.to(dev) for k, v in inp.items()}


def _min_boundary_gap(inp, rands, n_iters, accel):
    """rands (B,K,T) (or (B,T) for one draw per node)."""
    probs = search.node_probs(inp["logits"], inp["n_edge"], inp["w_edge"], inp["c_puct"],
                              inp["q_bounds"], n_iters=n_iters, accel=accel).double()
    cum = probs.cumsum(-1)  # (B,T,A)
    r = rands.double() if rands.dim() == 3 else rands.double()[:, None]
    return float((cum[:, None] - r[..., None]).abs().min())


def _away_from_boundaries(inp, rands, n_iters, accel, seed):
    """rands (B,K,T) (or (B,T)) with every uniform within 1e-5 of the twin's
    CDF redrawn, so that each draw must equal the twin's."""
    gen = torch.Generator().manual_seed(seed + 1000)
    probs = search.node_probs(inp["logits"], inp["n_edge"], inp["w_edge"], inp["c_puct"],
                              inp["q_bounds"], n_iters=n_iters, accel=accel).double()
    cum = probs.cumsum(-1)[:, None]  # (B,1,T,A)
    rands = rands.clone()
    for _ in range(20):
        r = rands if rands.dim() == 3 else rands[:, None]
        near = ((cum - r.double()[..., None]).abs() < 1e-5).any(-1)
        near = near if rands.dim() == 3 else near[:, 0]
        if not near.any():
            return rands
        rands[near] = torch.rand(int(near.sum()), generator=gen)
    raise AssertionError("could not draw uniforms away from the CDF boundaries")


BOARD_ACTIONS = [9, 25, 36, 49, 81, 121]  # boards 3, 5, 6, 7, 9, 11


def _walk_inputs(seed, K, R=12):
    """terminal (B,R) and acts, nxt (K*B, R) rows drawn from a random tree."""
    B, A = 16, 7
    inp, terminal = _random_tree(seed, B, R, A)
    rands = torch.rand((B, K, R), generator=torch.Generator().manual_seed(seed))
    a, c = kernels.node_actions_multi_ref(rands=rands, **inp)  # (B,K,R)
    return terminal, a.permute(1, 0, 2).reshape(K * B, R), c.permute(1, 0, 2).reshape(K * B, R)


def _walk_form(x, K, form):
    """(K*B, R) rows as `walk` takes them: the rows themselves, or the
    (K,B,R) view of a (B,K,R) buffer, as the search hands the sampler's."""
    if form == "rows":
        return x
    B = x.shape[0] // K
    return x.view(K, B, -1).permute(1, 0, 2).contiguous().permute(1, 0, 2)


def _walk_matches(cuda, terminal, acts, nxt, K, max_levels, form, design, gterm=None):
    """The kernel by `design` on the card, with acts/nxt in `form` and
    terminal `gterm` (default: `terminal` on the card), against `walk_ref`
    on the rows: all four outputs bit-equal, one launch. Where `design` is
    the one `walk_design` picks, `walk` itself gives the same."""
    ref = kernels.walk_ref(terminal, acts, nxt, max_levels=max_levels)
    gterm = terminal.to(cuda) if gterm is None else gterm
    ga, gn = (_walk_form(x.to(cuda), K, form) for x in (acts, nxt))
    n0 = kernels.launches["walk"]
    outs = [kernels._walk_launch(gterm, ga, gn, max_levels, design)]
    if design == kernels.walk_design(K, acts.shape[1]):
        outs.append(kernels.walk(gterm, ga, gn, max_levels=max_levels))
    torch.cuda.synchronize()
    assert kernels.launches["walk"] == n0 + len(outs)
    for out in outs:
        for name, r, o in zip(("parents", "actions", "halt_child", "path"), ref, out):
            assert o.dtype == torch.int32 and o.shape == r.shape, name
            assert torch.equal(o.cpu(), r), name
    return ref


WALK_DESIGNS = list(kernels.WALK_DESIGNS)


@pytest.mark.gpu
@pytest.mark.parametrize("design", WALK_DESIGNS)
@pytest.mark.parametrize("form", ["rows", "view"])
@pytest.mark.parametrize("K,max_levels,R", [
    (1, None, 12), (4, None, 12), (4, 3, 12),  # the first three cases, on both forms
    (8, 2, 12), (1, 5, 37), (4, None, 37), (8, 9, 37), (1, None, 64), (4, 9, 64),
    (8, None, 64), (1, 7, 65), (4, None, 65), (8, 9, 65), (8, None, 65)])
def test_walk_kernel_matches_ref(cuda, K, max_levels, R, form, design):
    terminal, acts, nxt = _walk_inputs(6, K, R)
    _walk_matches(cuda, terminal, acts, nxt, K, max_levels, form, design)


@pytest.mark.gpu
@pytest.mark.parametrize("design", WALK_DESIGNS)
@pytest.mark.parametrize("form", ["rows", "view"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("kind", ["chain", "terminal_root", "terminal_mid", "wide_terminal"])
def test_walk_kernel_special_trees(cuda, kind, K, form, design):
    # chain: every row a chain nxt[t] = t+1, 63 levels deep at R = 64;
    # terminal_root: a terminal root in every other env (rows stay inactive);
    # terminal_mid: chains that halt at a terminal child at depth 30;
    # wide_terminal: terminal as the leading R of a wider node axis
    B, R = 16, 64
    gen = torch.Generator().manual_seed(11)
    acts = torch.randint(0, 36, (K * B, R), generator=gen, dtype=torch.int32)
    chain = torch.arange(1, R + 1, dtype=torch.int32).repeat(K * B, 1)
    chain[:, -1] = -1
    terminal = torch.zeros((B, R), dtype=torch.bool)
    nxt, gterm = chain, None
    if kind == "terminal_root":
        terminal[::2, 0] = True
    elif kind == "terminal_mid":
        terminal[:, 30] = True
    elif kind == "wide_terminal":
        terminal, acts, nxt = _walk_inputs(8, K, R)
        wide = torch.rand((B, R + 7), generator=gen) < 0.3
        wide[:, :R] = terminal
        gterm = wide.to(cuda)[:, :R]
        assert gterm.stride(0) == R + 7
    ref = _walk_matches(cuda, terminal, acts, nxt, K, None, form, design, gterm)
    depth = (ref[3] >= 0).sum(1)
    if kind == "chain":
        assert (depth == R).all() and (ref[2] == -1).all()  # 63 steps down, no halting child
    elif kind == "terminal_root":
        assert (depth.view(K, B)[:, ::2] == 0).all() and (depth.view(K, B)[:, 1::2] == R).all()
    elif kind == "terminal_mid":
        assert (depth == 30).all() and (ref[2] == 30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [
    (9, 1.0, 16, False), (2, 0.0625, 16, False), (9, 1.0, 6, True), (2, 0.0625, 6, True)])
def test_node_actions_multi_kernel_matches_ref(cuda, seed, c_puct, n_iters, accel, A):
    B, T, K = 16, 12, 4
    inp, _ = _random_tree(seed, B, T, A, c_puct)
    rands = torch.rand((B, K, T), generator=torch.Generator().manual_seed(seed))
    rands = _away_from_boundaries(inp, rands, n_iters, accel, seed)
    assert _min_boundary_gap(inp, rands, n_iters, accel) > 1e-6
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, n_iters=n_iters, accel=accel,
                                                    return_alpha=True, **inp)
    n0 = kernels.launches["node_actions_multi"]
    ka, kc, kalpha = kernels.node_actions_multi(rands=rands.to(cuda), n_iters=n_iters,
                                                accel=accel, return_alpha=True, **_to(inp, cuda))
    torch.cuda.synchronize()
    assert kernels.launches["node_actions_multi"] == n0 + 1
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    assert torch.equal(ka.cpu(), ra)
    assert torch.equal(kc.cpu(), rc)


@pytest.mark.gpu
@pytest.mark.parametrize("A", BOARD_ACTIONS)
def test_node_actions_multi_kernel_wide_rows_and_slice(cuda, A):
    # rows in every lane layout, and a leading-row slice of the node axis as
    # the grow passes hand it over (env stride > rows * A)
    B, T, K, R = 8, 20, 8, 9
    inp, _ = _random_tree(4, B, T, A, c_puct=1 / 16)
    ref = {k: (v[:, :R].contiguous() if v.dim() == 3 else v) for k, v in inp.items()}
    rands = torch.rand((B, K, R), generator=torch.Generator().manual_seed(4))
    rands = _away_from_boundaries(ref, rands, 6, True, 4)
    sliced = {k: (v[:, :R] if v.dim() == 3 else v) for k, v in _to(inp, cuda).items()}
    ka, kc, kalpha = kernels.node_actions_multi(rands=rands.to(cuda), return_alpha=True, **sliced)
    assert _min_boundary_gap(ref, rands, 6, True) > 1e-6
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, return_alpha=True, **ref)
    torch.cuda.synchronize()
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    assert torch.equal(ka.cpu(), ra)
    assert torch.equal(kc.cpu(), rc)


@pytest.mark.gpu
def test_wrappers_raise_on_wrong_inputs(cuda):
    terminal, acts, nxt = _walk_inputs(6, 2)
    ga, gn, gt = acts.to(cuda), nxt.to(cuda), terminal.to(cuda)
    with pytest.raises(ValueError):
        kernels.walk(gt, ga.long(), gn)
    view = ga.view(2, 16, 12)
    for bad in (ga.view(2, 16, 12)[:, :, ::2], ga.view(2, 16, 12).transpose(1, 2)):
        with pytest.raises(ValueError, match="acts/nxt"):  # no unit stride along the nodes
            kernels.walk(gt[:, :bad.shape[2]], bad, bad)
    with pytest.raises(ValueError, match="nxt must match acts"):  # the strides differ
        kernels.walk(gt, view, gn.view(16, 2, 12).permute(1, 0, 2))
    with pytest.raises(ValueError, match="terminal"):
        kernels.walk(gt[:, :11], ga, gn)
    with pytest.raises(ValueError, match="K\\*B rows"):
        kernels.walk(gt, ga[:31], gn[:31])
    inp, _ = _random_tree(1, 4, 6, 7)
    bad = _to(inp, cuda)
    bad["n_edge"] = bad["n_edge"].float()  # int8 children come with bf16 counts only
    with pytest.raises(ValueError):
        kernels.node_actions_multi(rands=torch.rand((4, 2, 6), device=cuda), **bad)
    with pytest.raises(ValueError):
        kernels.node_actions(rands=torch.rand((4, 6), device=cuda), **bad)
    tree = _tree_to(_random_search_tree(1, 4, 6, 7), cuda)
    leaves = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # leaves must be int32
        kernels.backup(tree, leaves.long(), 1)
    for wrapper in (kernels.backup, kernels.backup_dense):  # the tensors the kernels write
        for name, bad in (("n", tree.n.float()), ("w_edge", tree.w_edge[:, :5]),
                          ("n_edge", tree.n_edge.half()), ("seats", tree.seats.cpu())):
            with pytest.raises(ValueError, match=f"^{name} must be"):
                wrapper(replace(tree, **{name: bad}), leaves, 1)
    with pytest.raises(ValueError):  # rands must be (B,T)
        kernels.descend(tree, torch.rand((4, 5), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
@pytest.mark.parametrize("seed,c_puct,B,T,R", [
    (9, 1.0, 16, 12, 12), (2, 0.0625, 16, 12, 12), (4, 1 / 16, 8, 20, 9)])
def test_node_actions_kernel_matches_ref(cuda, seed, c_puct, B, T, R, A):
    # R < T: the live-row slice the K=1 search hands over (env stride T*A)
    inp, _ = _random_tree(seed, B, T, A, c_puct)
    ref_inp = {k: (v[:, :R].contiguous() if v.dim() == 3 else v) for k, v in inp.items()}
    rands = torch.rand((B, R), generator=torch.Generator().manual_seed(seed))
    rands = _away_from_boundaries(ref_inp, rands, 16, False, seed)
    assert _min_boundary_gap(ref_inp, rands, 16, False) > 1e-6
    ra, rc = search.node_actions(rands=rands, **ref_inp)
    sliced = {k: (v[:, :R] if v.dim() == 3 else v) for k, v in _to(inp, cuda).items()}
    n0 = kernels.launches["node_actions"]
    ka, kc = kernels.node_actions(rands=rands.to(cuda), **sliced)
    torch.cuda.synchronize()
    assert kernels.launches["node_actions"] == n0 + 1
    assert ka.dtype == torch.int32 and ka.shape == (B, R)
    assert torch.equal(ka.cpu(), ra)
    assert torch.equal(kc.cpu(), rc)
    # the debug alpha: the root the draws used, which is solve_probs' at the
    # same 16 Newton steps bit for bit, and the twin's to float32 roundoff
    aa, ac, kalpha = kernels.node_actions(rands=rands.to(cuda), return_alpha=True, **sliced)
    assert torch.equal(aa, ka) and torch.equal(ac, kc)
    salpha = kernels.solve_probs(*(sliced[k] for k in ("logits", "n_edge", "w_edge", "c_puct",
                                                       "q_bounds")),
                                 n_iters=16, accel=False, out="alpha")
    assert torch.equal(kalpha, salpha)
    _, _, ralpha = kernels.node_actions(rands=rands, return_alpha=True, **ref_inp)
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (1, 0.0625), (2, 10.0)])
def test_descend_kernel_matches_ref(cuda, seed, c_puct, A):
    B, T = 16, 12
    tree = _random_search_tree(seed, B, T, A, c_puct)
    inp, _ = _random_tree(seed, B, T, A, c_puct)
    rands = torch.rand((B, T), generator=torch.Generator().manual_seed(seed))
    rands = _away_from_boundaries(inp, rands, 16, False, seed)
    assert _min_boundary_gap(inp, rands, 16, False) > 1e-6
    rp, ra = search.descend_reference(tree, rands)
    gtree = _tree_to(tree, cuda)
    n0 = kernels.launches["descend"]
    kp, ka = kernels.descend(gtree, rands.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["descend"] == n0 + 1
    assert torch.equal(kp.cpu(), rp) and torch.equal(ka.cpu(), ra)
    # node_actions + walk kernels on the card, bit for bit
    wp, wa = search.descend(gtree, rands.to(cuda))
    assert torch.equal(wp, kp) and torch.equal(wa, ka)


@pytest.mark.gpu
@pytest.mark.parametrize("npv", [1, 2])
@pytest.mark.parametrize("T", [12, 37, 64, 65])
@pytest.mark.parametrize("variant,n_seats", [("delta", 2), ("delta", 3), ("dense", 1),
                                              ("dense", 2), ("dense", 3)])
def test_backup_kernels_match_ref(cuda, variant, n_seats, T, npv):
    # even envs are chains with their leaf T-1 levels deep and a terminal
    # node on the path; envs 1, 5, 9, 13 back up from the root (depth 0)
    B, A = 16, 7
    tree = _random_search_tree(T, B, T, A, n_seats=n_seats, chains=True)
    leaves = np.random.default_rng(T).integers(0, T, B)
    leaves[0::2] = T - 1
    leaves[1::4] = 0
    leaves = torch.tensor(leaves, dtype=torch.int32)
    wrapper = kernels.backup if variant == "delta" else kernels.backup_dense
    ref = wrapper(_tree_to(tree, "cpu"), leaves, npv)  # the CPU tree: the twin
    n0 = kernels.launches[wrapper.__name__]
    out = wrapper(_tree_to(tree, cuda), leaves.to(cuda), npv)
    torch.cuda.synchronize()
    assert kernels.launches[wrapper.__name__] == n0 + 1
    for name in ("n", "w", "n_edge", "w_edge"):  # the twin's adds: bit for bit
        assert torch.equal(getattr(out, name).cpu(), getattr(ref, name)), name
    assert int((ref.n - tree.n)[0::2].sum()) == npv * T * B // 2


@pytest.mark.gpu
def test_k1_search_backs_up_in_the_kernel(cuda, monkeypatch):
    # one 6x6 64-node K=1 search on 1,024 envs from the same worlds and draws,
    # as it runs and with the `backup` kernel's twin in the kernel's place
    from boardlaw_tpu_torch import learning, train
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    cfg = train.best_config(6, n_envs=1024)
    model = train.build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    worlds = learning.mix(thex.Hex.initial(1024, 6, device=cuda), Draws(1, cuda), 20)
    trees, launched = {}, {}
    for backup in ("kernel", "twin"):
        with monkeypatch.context() as m:
            if backup == "twin":
                m.setattr(search.kernels, "backup", search.backup)
            n0 = kernels.launches["backup"]
            trees[backup] = search.mcts(worlds, make_eval_fn(model), Draws(2, cuda),
                                        cfg.mcts_config())
            torch.cuda.synchronize()
            launched[backup] = kernels.launches["backup"] - n0
    assert launched == {"kernel": 63, "twin": 0}
    for name in ("children", "parents", "relation", "n", "w", "n_edge", "w_edge"):
        assert torch.equal(getattr(trees["kernel"], name), getattr(trees["twin"], name)), name


def _same_bits(a, b):
    """a and b hold the same bits: -0.0 is not 0.0 here."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    return torch.equal(a.view(as_int), b.view(as_int)) if as_int else torch.equal(a, b)


@contextlib.contextmanager
def _serial_sums():
    """The CPU's accumulating index_put_ adds one entry after another, in
    entry order, only in deterministic mode (otherwise, on large inputs, in
    parallel with atomics)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _order_bound(before, mcfg):
    """What two orders of summing a pass's w_edge terms into w_edge may
    differ by, per edge: 2 (K + 1) u (|w_edge| + K max|term|), u = 2^-24,
    a term C_k[seat] - prew[t, seat] at most max|v| + 2 max|prew|."""
    K = mcfg.leaves_per_pass
    term = float(before.v.abs().max() + 2 * before.prew.abs().max())
    return 2 * (K + 1) * 2.0 ** -24 * (before.w_edge.abs() + K * term)


def _k8_search(cuda, nodes, n_envs, tree_dtype="float32", backup_n="seats", width=32):
    """The worlds, eval function and config of a 9x9 K=8 grow search on the
    card: `train.make_config`'s search, on worlds 60 random plies deep."""
    from boardlaw_tpu_torch import learning, train
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    cfg = train.make_config(9, width, 1, nodes=nodes, n_envs=n_envs, tree_dtype=tree_dtype)
    mcfg = replace(cfg.mcts_config(), backup_n=backup_n)
    model = train.build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    worlds = learning.mix(thex.Hex.initial(n_envs, 9, device=cuda), Draws(1, cuda), 60)
    return worlds, make_eval_fn(model), mcfg


@pytest.mark.gpu
@pytest.mark.parametrize("backup_n", ["seats", "visits"])
@pytest.mark.parametrize("tree_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nodes,n_envs", [(64, 256), (512, 32)])
def test_backup_prefix_matches_twin_mid_search(cuda, monkeypatch, nodes, n_envs, tree_dtype,
                                               backup_n):
    # at every pass of a real K=8 grow search (64 nodes: int8 children and
    # bf16 counts; 512: int32 and f32), the kernel on the pass's inputs
    # against the twin on the card and on the CPU, and a second launch
    worlds, eval_fn, mcfg = _k8_search(cuda, nodes, n_envs, tree_dtype, backup_n)
    inst = kernels.instance("backup_prefix", counts=search.tree_dtypes(mcfg)[1])
    assert inst == ("backup_prefix" if nodes == 64 else "backup_prefix.wide")
    kernel = kernels.backup_prefix
    seen = {"passes": 0, "duplicate leaves": 0, "terminal leaves": 0, "deepest path": 0}

    def checked(tree, paths, acts, leaves, npv):
        before = _tree_to(tree, "cpu")
        again = _tree_to(tree, cuda)
        card = search.backup_paths_prefix(_tree_to(tree, cuda), paths, acts, leaves, npv)
        n0 = kernels.launches[inst]
        out = kernel(tree, paths, acts, leaves, npv)
        kernel(again, paths, acts, leaves, npv)
        torch.cuda.synchronize()
        assert kernels.launches[inst] == n0 + 2
        with _serial_sums():
            ref = search.backup_paths_prefix(_tree_to(before, "cpu"), paths.cpu(), acts.cpu(),
                                             leaves.cpu(), npv)
        for name in ("n", "w", "n_edge", "w_edge"):  # the twin's adds on the card
            assert _same_bits(getattr(out, name), getattr(card, name)), name
            assert _same_bits(getattr(again, name), getattr(out, name)), name
        for name in ("n", "w", "n_edge"):  # the CPU's adds: the same association
            assert _same_bits(getattr(out, name).cpu(), getattr(ref, name)), name
        # w_edge: the CPU adds each walk's term to w_edge in turn, the card
        # adds their sum; two orders of at most K + 1 terms
        assert (out.w_edge.cpu() - ref.w_edge).abs().le(_order_bound(before, mcfg)).all()
        lv = leaves.cpu()
        seen["passes"] += 1
        seen["duplicate leaves"] += int((lv[:, None] == lv[None]).sum() - lv.numel())
        seen["terminal leaves"] += int(before.terminal.gather(1, lv.t().long()).sum())
        seen["deepest path"] = max(seen["deepest path"], int((paths >= 0).sum(-1).max()))
        return out

    monkeypatch.setattr(kernels, "backup_prefix", checked)
    search.mcts(worlds, eval_fn, Draws(2, cuda), mcfg)
    assert seen["passes"] == mcfg.n_passes
    # duplicate and terminal leaves, and paths below the root's children
    assert seen["duplicate leaves"] and seen["terminal leaves"], seen
    assert seen["deepest path"] >= 3, seen


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,n_envs", [(64, 1024), (512, 64)])
def test_k8_search_backs_up_in_the_kernel_and_repeats(cuda, nodes, n_envs):
    # the K=8 search launches `backup_prefix` once a pass on a card tree,
    # and, every sum now in a fixed order, two searches of one seed build
    # the same tree bit for bit
    worlds, eval_fn, mcfg = _k8_search(cuda, nodes, n_envs, width=64)
    inst = kernels.instance("backup_prefix", counts=search.tree_dtypes(mcfg)[1])
    trees = []
    for _ in range(2):
        n0 = kernels.launches[inst]
        trees.append(search.mcts(worlds, eval_fn, Draws(2, cuda), mcfg))
        torch.cuda.synchronize()
        assert kernels.launches[inst] - n0 == mcfg.n_passes
    for name in ("children", "parents", "relation", "n", "w", "n_edge", "w_edge", "prew"):
        assert _same_bits(getattr(trees[0], name), getattr(trees[1], name)), name


def _solve_inputs(inp):
    return {k: inp[k] for k in ("logits", "n_edge", "w_edge", "c_puct", "q_bounds")}


def _lead(inp, R, copy=False):
    """The leading R node rows of the (B,T,A) inputs: views, or copies."""
    return {k: ((v[:, :R].contiguous() if copy else v[:, :R]) if v.dim() == 3 else v)
            for k, v in inp.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("out", ["probs", "alpha"])
@pytest.mark.parametrize("seed,B,T,A,R,n_iters,accel", [
    (9, 16, 12, 7, 12, 6, True), (2, 16, 12, 7, 12, 16, False), (4, 8, 20, 81, 9, 6, True)]
    + [(5, 8, 20, A, 9, 6, True) for A in BOARD_ACTIONS if A != 81])
def test_solve_probs_kernel_matches_ref(cuda, out, seed, B, T, A, R, n_iters, accel):
    # R < T: a leading-row slice of the node axis (env stride T*A)
    inp, _ = _random_tree(seed, B, T, A, c_puct=1 / 16)
    ref = kernels.solve_probs_ref(n_iters=n_iters, accel=accel, out=out,
                                  **_lead(_solve_inputs(inp), R, copy=True))
    sliced = _lead(_to(inp, cuda), R)
    n0 = kernels.launches["solve_probs"]
    res = kernels.solve_probs(n_iters=n_iters, accel=accel, out=out, **_solve_inputs(sliced))
    torch.cuda.synchronize()
    assert kernels.launches["solve_probs"] == n0 + 1
    assert res.dtype == torch.float32 and res.is_contiguous() and res.shape == ref.shape
    torch.testing.assert_close(res.cpu(), ref, rtol=1e-5, atol=1e-7)
    if out == "alpha":  # the same floats as the fused kernel's roots
        _, _, alpha = kernels.node_actions_multi(rands=torch.rand((B, 2, R), device=cuda),
                                                 n_iters=n_iters, accel=accel, return_alpha=True,
                                                 **sliced)
        assert torch.equal(alpha, res)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,B,T,A,K,R", [(6, 16, 12, 7, 4, 12), (4, 8, 20, 81, 8, 9)]
                         + [(5, 8, 20, A, 8, 9) for A in BOARD_ACTIONS if A != 81]
                         + [(7, 8, 20, 36, 20, 9)])  # K > G: the draws in two rounds
def test_sample_children_multi_kernel_matches_ref_and_fused(cuda, seed, B, T, A, K, R):
    inp, _ = _random_tree(seed, B, T, A, c_puct=1 / 16)
    sliced = _lead(_to(inp, cuda), R)
    rands = torch.rand((B, K, R), generator=torch.Generator().manual_seed(seed)).to(cuda)
    probs = kernels.solve_probs(**_solve_inputs(sliced))
    n0 = kernels.launches["sample_children_multi"]
    ka, kc = kernels.sample_children_multi(probs, sliced["children"], rands)
    torch.cuda.synchronize()
    assert kernels.launches["sample_children_multi"] == n0 + 1
    assert ka.dtype == kc.dtype == torch.int32 and ka.shape == (B, K, R)
    # the twin on the same probs, bit for bit
    ra, rc = kernels.sample_children_multi_ref(probs.cpu(), inp["children"][:, :R], rands.cpu())
    assert torch.equal(ka.cpu(), ra) and torch.equal(kc.cpu(), rc)
    # the split pair draws what the fused kernel draws
    fa, fc = kernels.node_actions_multi(rands=rands, **sliced)
    assert torch.equal(ka, fa) and torch.equal(kc, fc)
    # probs given as a leading slice of a wider node axis
    wide = torch.zeros((B, T, A), device=cuda)
    wide[:, :R] = probs
    wa, wc = kernels.sample_children_multi(wide[:, :R], sliced["children"], rands)
    assert torch.equal(wa, ka) and torch.equal(wc, kc)


@pytest.mark.gpu
def test_split_wrappers_raise_on_wrong_inputs(cuda):
    inp, _ = _random_tree(1, 4, 6, 7)
    good = _solve_inputs(_to(inp, cuda))
    with pytest.raises(ValueError):
        kernels.solve_probs(**{**good, "n_edge": good["n_edge"].half()})
    with pytest.raises(ValueError):
        kernels.solve_probs(**{**good, "c_puct": good["c_puct"][:2]})
    with pytest.raises(ValueError):
        kernels.solve_probs(out="both", **good)
    probs = kernels.solve_probs(**good)
    children = inp["children"].to(cuda)
    rands = torch.rand((4, 2, 6), device=cuda)
    with pytest.raises(ValueError):
        kernels.sample_children_multi(probs.double(), children, rands)
    with pytest.raises(ValueError):
        kernels.sample_children_multi(probs, children.short(), rands)
    with pytest.raises(ValueError):
        kernels.sample_children_multi(probs, children, rands.permute(0, 2, 1).contiguous())


def _bf16_logits(inp):
    """The inputs with their logits rounded to bf16."""
    return {**inp, "logits": inp["logits"].bfloat16()}


def _f32_copy(inp):
    return {**inp, "logits": inp["logits"].float()}


def _launch_counts(wrapper):
    return kernels.launches[wrapper.__name__], kernels.launches[wrapper.__name__ + ".bf16"]


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
@pytest.mark.parametrize("n_iters,accel", [(16, False), (6, True)])
def test_node_actions_multi_bf16_matches_ref_and_f32(cuda, n_iters, accel, A):
    # a leading-row slice of bf16 rows, as the grow passes hand them over
    B, T, K, R = 8, 20, 8, 13
    inp, _ = _random_tree(4, B, T, A, c_puct=1 / 16)
    inp = _bf16_logits(inp)
    ref_inp = _lead(inp, R, copy=True)
    rands = torch.rand((B, K, R), generator=torch.Generator().manual_seed(A))
    rands = _away_from_boundaries(ref_inp, rands, n_iters, accel, A)
    assert _min_boundary_gap(ref_inp, rands, n_iters, accel) > 1e-6
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, n_iters=n_iters, accel=accel,
                                                    return_alpha=True, **ref_inp)
    kw = dict(rands=rands.to(cuda), n_iters=n_iters, accel=accel, return_alpha=True)
    n0 = _launch_counts(kernels.node_actions_multi)
    ka, kc, kalpha = kernels.node_actions_multi(**kw, **_lead(_to(inp, cuda), R))
    torch.cuda.synchronize()
    assert _launch_counts(kernels.node_actions_multi) == (n0[0], n0[1] + 1)
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    assert torch.equal(ka.cpu(), ra) and torch.equal(kc.cpu(), rc)
    fa, fc, falpha = kernels.node_actions_multi(**kw, **_lead(_to(_f32_copy(inp), cuda), R))
    assert torch.equal(ka, fa) and torch.equal(kc, fc) and torch.equal(kalpha, falpha)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
def test_node_actions_bf16_matches_ref_and_f32(cuda, A):
    B, T, R = 8, 20, 9
    inp, _ = _random_tree(2, B, T, A, c_puct=1 / 16)
    inp = _bf16_logits(inp)
    ref_inp = _lead(inp, R, copy=True)
    rands = torch.rand((B, R), generator=torch.Generator().manual_seed(A))
    rands = _away_from_boundaries(ref_inp, rands, 16, False, A)
    assert _min_boundary_gap(ref_inp, rands, 16, False) > 1e-6
    ra, rc = search.node_actions(rands=rands, **ref_inp)
    n0 = _launch_counts(kernels.node_actions)
    ka, kc = kernels.node_actions(rands=rands.to(cuda), **_lead(_to(inp, cuda), R))
    torch.cuda.synchronize()
    assert _launch_counts(kernels.node_actions) == (n0[0], n0[1] + 1)
    assert torch.equal(ka.cpu(), ra) and torch.equal(kc.cpu(), rc)
    fa, fc = kernels.node_actions(rands=rands.to(cuda), **_lead(_to(_f32_copy(inp), cuda), R))
    assert torch.equal(ka, fa) and torch.equal(kc, fc)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (2, 10.0)])
def test_descend_bf16_matches_ref_and_f32(cuda, seed, c_puct, A):
    B, T = 16, 12
    tree = _random_search_tree(seed, B, T, A, c_puct)
    tree = replace(tree, logits=tree.logits.bfloat16())
    inp = dict(logits=tree.logits, n_edge=tree.n_edge, w_edge=tree.w_edge, c_puct=tree.c_puct,
               q_bounds=search._q_bounds(tree))
    rands = torch.rand((B, T), generator=torch.Generator().manual_seed(seed))
    rands = _away_from_boundaries(inp, rands, 16, False, seed)
    rp, ra = search.descend_reference(tree, rands)
    gtree = _tree_to(tree, cuda)
    n0 = _launch_counts(kernels.descend)
    kp, ka = kernels.descend(gtree, rands.to(cuda))
    torch.cuda.synchronize()
    assert _launch_counts(kernels.descend) == (n0[0], n0[1] + 1)
    assert torch.equal(kp.cpu(), rp) and torch.equal(ka.cpu(), ra)
    fp, fa = kernels.descend(replace(gtree, logits=gtree.logits.float()), rands.to(cuda))
    assert torch.equal(kp, fp) and torch.equal(ka, fa)
    # node_actions + walk kernels on the bf16 tree, bit for bit
    wp, wa = search.descend(gtree, rands.to(cuda))
    assert torch.equal(wp, kp) and torch.equal(wa, ka)


@pytest.mark.gpu
@pytest.mark.parametrize("out", ["probs", "alpha"])
@pytest.mark.parametrize("A", [7] + BOARD_ACTIONS)
def test_solve_probs_bf16_matches_ref_and_f32(cuda, A, out):
    B, T, R = 8, 20, 9
    inp, _ = _random_tree(5, B, T, A, c_puct=1 / 16)
    inp = _solve_inputs(_bf16_logits(inp))
    n0 = _launch_counts(kernels.solve_probs)
    res = kernels.solve_probs(out=out, **_lead(_to(inp, cuda), R))
    torch.cuda.synchronize()
    assert _launch_counts(kernels.solve_probs) == (n0[0], n0[1] + 1)
    if out == "alpha":
        ref = kernels.solve_probs_ref(out=out, **_lead(inp, R, copy=True))
    else:  # the probs: the twin's formula at the kernel's roots (chip_smoke phase 3b's rule)
        alpha = kernels.solve_probs(out="alpha", **_lead(_to(inp, cuda), R))
        ref = search.node_probs(**_lead(inp, R, copy=True), fixed_alpha=alpha.cpu())
    torch.testing.assert_close(res.cpu(), ref, rtol=1e-5, atol=1e-7)
    f32 = kernels.solve_probs(out=out, **_lead(_to(_f32_copy(inp), cuda), R))
    assert torch.equal(res, f32)


@pytest.mark.gpu
def test_logits_wrappers_refuse_other_dtypes(cuda):
    inp, _ = _random_tree(1, 4, 6, 7)
    half = {**_to(inp, cuda), "logits": inp["logits"].half().to(cuda)}
    with pytest.raises(ValueError, match="logits must be float32 or bfloat16"):
        kernels.node_actions_multi(rands=torch.rand((4, 2, 6), device=cuda), **half)
    with pytest.raises(ValueError, match="logits must be float32 or bfloat16"):
        kernels.node_actions(rands=torch.rand((4, 6), device=cuda), **half)
    with pytest.raises(ValueError, match="logits must be float32 or bfloat16"):
        kernels.solve_probs(**_solve_inputs(half))
    tree = _tree_to(_random_search_tree(1, 4, 6, 7), cuda)
    with pytest.raises(ValueError, match="logits must be float32 or bfloat16"):
        kernels.descend(replace(tree, logits=tree.logits.half()), torch.rand((4, 6), device=cuda))


# ---------------------------------------------------------------------------
# the wide tree: int32 children, bf16 or f32 edge counts
# ---------------------------------------------------------------------------

MIXED = (torch.int32, torch.bfloat16)
WIDE = (torch.int32, torch.float32)
# (dtypes, T, the counter's name): the mixed case at T = 128, the wide one at
# 300 and 513 (K = 8 with n_nodes = 512)
WIDE_TREES = [(MIXED, 128, "mixed"), (WIDE, 300, "wide"), (WIDE, 513, "wide")]


def _counts(wrapper):
    return {n: v for n, v in kernels.launches.items() if n.split(".")[0] == wrapper.__name__}


def _one_launch_on(wrapper, before, name):
    after = _counts(wrapper)
    assert after == {k: v + (k == name) for k, v in before.items()}, (name, before, after)


@pytest.mark.gpu
@pytest.mark.parametrize("logits", ["float32", "bfloat16"])
@pytest.mark.parametrize("A", [9, 81])
@pytest.mark.parametrize("dtypes,T,inst", WIDE_TREES)
def test_wide_row_kernels_match_ref(cuda, dtypes, T, inst, A, logits):
    B, K = 4, 8
    inp, _ = _random_tree(T + A, B, T, A, c_puct=1 / 16, dtypes=dtypes)
    inp = {**inp, "logits": inp["logits"].to(getattr(torch, logits))}
    assert int(inp["children"].max()) > (T // 2 if T == 128 else 256)
    tag = ".bf16" if logits == "bfloat16" else ""
    g = _to(inp, cuda)
    rands = torch.rand((B, K, T), generator=torch.Generator().manual_seed(T))
    rands = _away_from_boundaries(inp, rands, 6, True, T)
    # node_actions_multi
    n0 = _counts(kernels.node_actions_multi)
    ka, kc, kalpha = kernels.node_actions_multi(rands=rands.to(cuda), return_alpha=True, **g)
    torch.cuda.synchronize()
    _one_launch_on(kernels.node_actions_multi, n0, f"node_actions_multi.{inst}{tag}")
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, return_alpha=True, **inp)
    assert torch.equal(ka.cpu(), ra) and torch.equal(kc.cpu(), rc)
    if logits == "float32":
        torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    else:  # bf16 logits: the f32 instantiation on their f32 copy, bit for bit
        fa, fc, falpha = kernels.node_actions_multi(rands=rands.to(cuda), return_alpha=True,
                                                    **_f32_copy(g))
        assert torch.equal(ka, fa) and torch.equal(kc, fc) and torch.equal(kalpha, falpha)
    # the split pair, from the same tree: the same draws
    n0 = _counts(kernels.solve_probs), _counts(kernels.sample_children_multi)
    probs = kernels.solve_probs(**_solve_inputs(g))
    sa, sc = kernels.sample_children_multi(probs, g["children"], rands.to(cuda))
    torch.cuda.synchronize()
    counts_inst = "wide" if inst == "wide" else ""
    _one_launch_on(kernels.solve_probs, n0[0],
                   ".".join(x for x in ("solve_probs", counts_inst, tag[1:]) if x))
    _one_launch_on(kernels.sample_children_multi, n0[1], "sample_children_multi.wide")
    assert torch.equal(sa, ka) and torch.equal(sc, kc)
    pa, pc = kernels.sample_children_multi_ref(probs.cpu(), inp["children"], rands)
    assert torch.equal(sa.cpu(), pa) and torch.equal(sc.cpu(), pc)
    # node_actions (K = 1), on a leading slice of the rows
    R = T - 3
    ref_inp = _lead(inp, R, copy=True)
    r1 = _away_from_boundaries(ref_inp, rands[:, 0, :R].contiguous(), 16, False, T)
    n0 = _counts(kernels.node_actions)
    na, nc = kernels.node_actions(rands=r1.to(cuda), **_lead(g, R))
    torch.cuda.synchronize()
    _one_launch_on(kernels.node_actions, n0, f"node_actions.{inst}{tag}")
    ra, rc = search.node_actions(rands=r1, **ref_inp)
    assert torch.equal(na.cpu(), ra) and torch.equal(nc.cpu(), rc)
    if T == 128:  # the compact instantiation on int8 copies of the ids, bit for bit
        narrow = {**_lead(g, R), "children": g["children"].to(torch.int8)[:, :R]}
        ca, cc = kernels.node_actions(rands=r1.to(cuda), **narrow)
        assert torch.equal(ca, na) and torch.equal(cc, nc)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [9, 81])
@pytest.mark.parametrize("dtypes,T,inst", WIDE_TREES)
def test_wide_descend_matches_ref(cuda, dtypes, T, inst, A):
    B = 8
    tree = _random_search_tree(T, B, T, A, 1.0, chains=True, dtypes=dtypes)
    inp = dict(logits=tree.logits, n_edge=tree.n_edge, w_edge=tree.w_edge, c_puct=tree.c_puct,
               q_bounds=search._q_bounds(tree))
    rands = torch.rand((B, T), generator=torch.Generator().manual_seed(T))
    rands = _away_from_boundaries(inp, rands, 16, False, T)
    rp, ra = search.descend_reference(tree, rands)
    gtree = _tree_to(tree, cuda)
    n0 = _counts(kernels.descend)
    kp, ka = kernels.descend(gtree, rands.to(cuda))
    torch.cuda.synchronize()
    _one_launch_on(kernels.descend, n0, f"descend.{inst}")
    assert torch.equal(kp.cpu(), rp) and torch.equal(ka.cpu(), ra)
    wp, wa = search.descend(gtree, rands.to(cuda))  # node_actions + walk on the card
    assert torch.equal(wp, kp) and torch.equal(wa, ka)


@pytest.mark.gpu
@pytest.mark.parametrize("npv", [1, 2])
@pytest.mark.parametrize("variant,n_seats", [("delta", 2), ("dense", 1), ("dense", 3)])
@pytest.mark.parametrize("dtypes,T,inst", WIDE_TREES)
def test_wide_backup_kernels_match_ref(cuda, dtypes, T, inst, variant, n_seats, npv):
    B, A = 8, 9
    tree = _random_search_tree(T, B, T, A, n_seats=n_seats, chains=True, dtypes=dtypes)
    leaves = np.random.default_rng(T).integers(0, T, B)
    leaves[0::2] = T - 1
    leaves = torch.tensor(leaves, dtype=torch.int32)
    wrapper = kernels.backup if variant == "delta" else kernels.backup_dense
    ref = wrapper(_tree_to(tree, "cpu"), leaves, npv)
    n0 = _counts(wrapper)
    out = wrapper(_tree_to(tree, cuda), leaves.to(cuda), npv)
    torch.cuda.synchronize()
    # bf16 counts (T = 128) take the compact instantiation
    _one_launch_on(wrapper, n0, wrapper.__name__ + (".wide" if inst == "wide" else ""))
    for name in ("n", "w", "n_edge", "w_edge"):
        assert torch.equal(getattr(out, name).cpu(), getattr(ref, name)), name
    assert int((ref.n - tree.n)[0::2].sum()) == npv * T * B // 2


@pytest.mark.gpu
@pytest.mark.parametrize("design", WALK_DESIGNS)
@pytest.mark.parametrize("K,R,max_levels", [(8, 513, 65), (1, 256, 256), (1, 513, 513)])
def test_walk_kernel_wide_trees(cuda, K, R, max_levels, design):
    # random trees of the wide shapes, and depth-(R-1) chains at K = 1
    B = 8
    gen = torch.Generator().manual_seed(R)
    tree = _random_search_tree(R, B, R, 9, chains=True, dtypes=WIDE)
    rands = torch.rand((B, K, R), generator=gen)
    a, c = kernels.node_actions_multi_ref(
        tree.logits, tree.n_edge, tree.w_edge, tree.children, rands, tree.c_puct,
        search._q_bounds(tree))
    acts, nxt = (x.permute(1, 0, 2).reshape(K * B, R) for x in (a, c))
    for form in ("rows", "view"):
        _walk_matches(cuda, tree.terminal, acts, nxt, K, max_levels, form, design)
    if K == 1:
        chain = torch.arange(1, R + 1, dtype=torch.int32).repeat(B, 1)
        chain[:, -1] = -1
        ref = _walk_matches(cuda, torch.zeros((B, R), dtype=torch.bool), acts, chain, 1,
                            max_levels, "rows", design)
        assert ((ref[3] >= 0).sum(1) == min(R, max_levels)).all()


@pytest.mark.gpu
def test_wide_wrappers_refuse_other_dtypes(cuda):
    inp, _ = _random_tree(1, 4, 6, 7, dtypes=WIDE)
    g = _to(inp, cuda)
    rands = torch.rand((4, 2, 6), device=cuda)
    for children, n_edge in ((torch.int8, torch.float32), (torch.int16, torch.float32),
                             (torch.int64, torch.float32), (torch.int32, torch.float16)):
        bad = {**g, "children": g["children"].to(children), "n_edge": g["n_edge"].to(n_edge)}
        with pytest.raises(ValueError):
            kernels.node_actions_multi(rands=rands, **bad)
        with pytest.raises(ValueError):
            kernels.node_actions(rands=rands[:, 0].contiguous(), **bad)
        tree = replace(_tree_to(_random_search_tree(1, 4, 6, 7, dtypes=WIDE), cuda),
                       children=bad["children"], n_edge=bad["n_edge"])
        with pytest.raises(ValueError):
            kernels.descend(tree, rands[:, 0].contiguous())
    with pytest.raises(ValueError):
        kernels.sample_children_multi(kernels.solve_probs(**_solve_inputs(g)),
                                      g["children"].long(), rands)
    with pytest.raises(ValueError):
        kernels.solve_probs(**_solve_inputs({**g, "n_edge": g["n_edge"].double()}))


# --------------------------------------------------------------------------
# hex_step: bit-equal to its twin, envs.hex.step_reference
# --------------------------------------------------------------------------

HEX_SIZES = [3, 5, 6, 7, 9, 11]


def _hex_step_matches(board, seats, actions, reset):
    """One `kernels.hex_step` launch against the twin on the same card
    tensors: boards, seats, rewards (bit patterns: signed zeros too) and
    terminal flags equal. Returns the twin's outputs."""
    n0 = kernels.launches["hex_step"]
    got = kernels.hex_step(board, seats, actions, reset)
    torch.cuda.synchronize()
    assert kernels.launches["hex_step"] == n0 + 1
    want = thex.step_reference(board, seats, actions, reset)
    for name, g, w in zip(("board", "seats", "rewards", "terminal"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "rewards":
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name
    return want


def _random_labels(S, B, seed, device):
    gen = torch.Generator().manual_seed(seed)
    board = torch.randint(0, 7, (B, S, S), generator=gen, dtype=torch.uint8)
    seats = torch.randint(0, 2, (B,), generator=gen, dtype=torch.int32)
    return board.to(device), seats.to(device), gen


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("S", HEX_SIZES)
def test_hex_step_matches_twin_in_random_play(cuda, S, reset, dtype):
    # random valid moves (an occupied cell once a board without reset is
    # full) from the empty board, S*S plies, every ply held to the twin
    B = 512
    gen = torch.Generator().manual_seed(S)
    board = torch.zeros((B, S, S), dtype=torch.uint8, device=cuda)
    seats = torch.zeros((B,), dtype=torch.int32, device=cuda)
    n_terminal = n_edge = 0
    for _ in range(S * S + 2):
        world = thex.Hex(board=board, seats=seats)
        noise = torch.rand((B, S * S), generator=gen).to(cuda)
        actions = torch.argmax(torch.where(world.valid, noise, -1.0), -1).to(dtype)
        board, seats, _, terminal = _hex_step_matches(board, seats, actions, reset)
        n_terminal += int(terminal.sum())
        n_edge += int((board >= thex.TOP).sum())
    assert n_edge > 0 and (n_terminal > 0) == reset


@pytest.mark.gpu
@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("S", HEX_SIZES)
def test_hex_step_matches_twin_on_random_labels(cuda, S, reset):
    # every label anywhere, either seat, actions from -S to S*S+S (those
    # outside the board place nothing), int32 and int64
    B = 4096
    board, seats, gen = _random_labels(S, B, 100 + S, cuda)
    actions = torch.randint(-S, S * S + S, (B,), generator=gen, dtype=torch.int32).to(cuda)
    for dtype in (torch.int32, torch.int64):
        _hex_step_matches(board, seats, actions.to(dtype), reset)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [3, 9, 11])
def test_hex_step_at_every_edge_and_corner(cuda, S):
    # each border cell, in either seat's frame, on random labels
    border = [r * S + c for r in range(S) for c in range(S) if r in (0, S - 1) or c in (0, S - 1)]
    B = 64 * len(border)
    board, seats, _ = _random_labels(S, B, 200 + S, cuda)
    actions = torch.tensor(border, dtype=torch.int64, device=cuda).repeat(64)
    for reset in (True, False):
        _hex_step_matches(board, seats, actions, reset)


def _serpentine(S, seat):
    """Boards whose plain stones of `seat` snake over every even row (for
    white, column), joined at alternate ends, less the snake's first or its
    last cell; and the moves that fill that cell, in the mover's frame."""
    path = []
    for r in range(0, S, 2):
        cols = range(S) if r % 4 == 0 else range(S - 1, -1, -1)
        path += [(r, c) for c in cols]
        if r + 1 < S:
            path.append((r + 1, path[-1][1]))
    board = torch.zeros((S, S), dtype=torch.uint8)
    for cell in path:
        board[cell] = thex.BLACK
    if seat == 1:  # white's snake is black's, transposed
        board = torch.where(board == thex.BLACK, thex.WHITE, 0).to(torch.uint8).t().contiguous()
    boards, actions = [], []
    for r, c in (path[0], path[-1]):
        b = board.clone()
        b[(r, c) if seat == 0 else (c, r)] = thex.EMPTY
        boards.append(b)
        actions.append(r * S + c)  # white plays (a % S, a // S)
    return torch.stack(boards), torch.tensor(actions, dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("seat", [0, 1])
@pytest.mark.parametrize("S", [5, 6, 9, 11])
def test_hex_step_floods_serpentine_groups(cuda, S, seat):
    # the completing stone touches an edge, and the whole snake takes its
    # label: the flood crosses the board
    boards, actions = _serpentine(S, seat)
    seats = torch.full((len(boards),), seat, dtype=torch.int32)
    stone = thex.BLACK if seat == 0 else thex.WHITE
    for reset in (True, False):
        board, _, _, terminal = _hex_step_matches(boards.to(cuda), seats.to(cuda),
                                                  actions.to(cuda), reset)
        assert not terminal.any()
        n_stones = int((boards[0] == stone).sum()) + 1
        assert ((board >= thex.TOP).flatten(1).sum(1) == n_stones).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 255, 257, 262144])
def test_hex_step_batch_sizes(cuda, B):
    # whole tiles, a ragged last tile and a single board; 262,144 is the
    # 9x9 grow pass's K*B
    board, seats, gen = _random_labels(9, B, B, cuda)
    actions = torch.randint(0, 81, (B,), generator=gen).to(cuda)
    for reset in (True, False):
        _hex_step_matches(board, seats, actions, reset)
        _hex_step_matches(board, seats, actions.int(), reset)


class _NumpyGumbel(Draws):
    """Gumbel noise from one numpy generator, on `device`: the card and the
    CPU draw the same numbers."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)

    def gumbel(self, shape):
        return torch.from_numpy(self.rng.gumbel(size=tuple(shape)).astype(np.float32)).to(
            self.device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,S", [("Lazy", 5), ("Random", 5), ("Random", 9)])
def test_solitaire_game_on_the_card_matches_the_cpu(cuda, kind, S):
    # 20 plies of one-player Hex, the opponent included: Solitaire steps
    # through Hex.step, so the card's game takes the kernel, two launches a
    # ply, and the CPU's the twin
    B = 256
    cls = getattr(thex, kind)
    worlds = {d: cls.initial(B, S, device=d) for d in ("cpu", cuda)}
    draws = {d: _NumpyGumbel(S, d) for d in worlds}
    rng = np.random.default_rng(S)
    for _ in range(20):
        valid = worlds["cpu"].valid.numpy()
        actions = torch.tensor([rng.choice(np.flatnonzero(v)) for v in valid])
        n0 = kernels.launches["hex_step"]
        out = {d: worlds[d].step(actions.to(d), draws=draws[d]) for d in worlds}
        assert kernels.launches["hex_step"] == n0 + 2
        (cw, ct), (gw, gt) = out["cpu"], out[cuda]
        assert type(gw) is cls
        assert torch.equal(gw.board.cpu(), cw.board) and torch.equal(gw.seats.cpu(), cw.seats)
        assert torch.equal(gt.terminal.cpu(), ct.terminal)
        assert torch.equal(gt.rewards.cpu(), ct.rewards)
        worlds = {"cpu": cw, cuda: gw}


@pytest.mark.gpu
def test_hex_step_refuses_what_it_does_not_take(cuda):
    board = torch.zeros((4, 12, 12), dtype=torch.uint8, device=cuda)
    seats = torch.zeros((4,), dtype=torch.int32, device=cuda)
    actions = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1 to 11"):
        kernels.hex_step(board, seats, actions)
    with pytest.raises(ValueError, match="actions must be int32 or int64"):
        kernels.hex_step(board[:, :9, :9].contiguous(), seats, actions.short())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernels.hex_step(board[:, :9, :9].contiguous(), seats, actions.cpu())


def _launches_and_flood_syncs(fn):
    """`hex_step` launches and `sync.hex.flood` waits of one call of `fn`,
    with the port's tracing on; and the `hex.step` spans it opened."""
    from boardlaw_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    n0 = kernels.launches["hex_step"]
    profiling.enable()
    profiling.reset()
    try:
        fn()
        torch.cuda.synchronize()
        counts, totals = profiling.counters(), profiling.totals()
    finally:
        profiling.enable(False)
        profiling.reset()
    return (kernels.launches["hex_step"] - n0, counts.get(thex.SYNC_FLOOD, 0),
            totals.get(thex.STEP, (0,))[0], thex.FLOOD in totals)


@pytest.mark.gpu
@pytest.mark.parametrize("boardsize,expected", [(9, 9), (6, 64)])
def test_hex_step_launches_a_train_step(cuda, boardsize, expected):
    # 9x9: K=8 grow, 8 passes and the actor's step; 6x6: K=1, 63 sims and
    # the actor's step. The flood's host waits are gone.
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws as TorchDraws

    if boardsize == 9:
        cfg = train.make_config(9, 32, 1, n_envs=64, buffer_len=3, mix_steps=5)
    else:
        cfg = train.best_config(6, n_envs=64, buffer_len=3, mix_steps=5)
    _, _, init, warmup, step = train.make_train(cfg, device=cuda)
    d = TorchDraws(0, cuda)
    state = warmup(init(d), d)
    launched, waits, spans, flooded = _launches_and_flood_syncs(lambda: step(state, d))
    assert (launched, waits, spans, flooded) == (expected, 0, expected, False)


@pytest.mark.gpu
def test_hex_step_launches_a_league_ply(cuda):
    # a ply: one K=8 grow search at 64 nodes (8 passes) and the world's step
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.arena import neural
    from boardlaw_tpu_torch.mcts.search import MCTSAgent
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    cfg = train.make_config(9, 32, 1)
    agents = {name: MCTSAgent(make_eval_fn(train.build_model(cfg, device=cuda)), n_nodes=64,
                              c_puct=1 / 16, leaves_per_pass=8, grow_passes=True)
              for name in ("a", "b")}
    ev = neural.ChunkEvaluator(9, 32, agents, neural.all_matchups(list(agents)), 10 ** 9,
                               seed=0, device=cuda)
    ev.step()
    launched, waits, spans, flooded = _launches_and_flood_syncs(ev.step)
    assert (launched, waits, spans, flooded) == (9, 0, 9, False)
