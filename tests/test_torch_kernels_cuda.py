"""The CUDA kernels against their plain twins, on the card.

Every case here needs a CUDA card and skips without one. The file imports
torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

`walk` is pure integer logic and must be bit-equal. `node_actions_multi`
sums its lanes in another order than the twin, so the solved alpha agrees to
rtol 1e-5; the draws are equal on these seeds, where no rand lies within
1e-6 of a CDF boundary (each case checks that).
"""
import numpy as np
import pytest
import torch

from boardlaw_tpu_torch.mcts import kernels, search

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_tree(seed, B, T, A, c_puct=1.0):
    """A random tree's solve inputs in the port's storage types (the tree of
    tests/test_pallas.py `_random_tree`, in numpy)."""
    rng = np.random.default_rng(seed)
    children = np.full((B, T, A), -1, np.int32)
    seats = rng.integers(0, 2, (B, T))
    terminal = np.zeros((B, T), bool)
    for b in range(B):
        for c in range(1, T):
            p = rng.integers(0, c)
            free = np.flatnonzero(children[b, p] == -1)
            if len(free) == 0:
                continue
            children[b, p, rng.choice(free)] = c
            terminal[b, c] = rng.random() < 0.15
    logits = rng.normal(0, 1, (B, T, A)).astype(np.float32)
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    n = rng.integers(1, 20, (B, T))
    w = rng.normal(0, 2, (B, T, 2)).astype(np.float32)
    expanded = children >= 0
    c = np.where(expanded, children, 0)
    bb = np.arange(B)[:, None, None]
    n_edge = np.where(expanded, n[bb, c], 0).astype(np.float32)
    w_edge = np.where(expanded, w[bb, c, seats[:, :, None]], 0).astype(np.float32)
    q = w / (n[..., None] + 1e-4)
    return dict(
        logits=torch.tensor(logits),
        n_edge=torch.tensor(n_edge).to(torch.bfloat16),
        w_edge=torch.tensor(w_edge),
        children=torch.tensor(children).to(torch.int8),
        c_puct=torch.full((B,), c_puct, dtype=torch.float32),
        q_bounds=torch.tensor([q.min(), q.max()], dtype=torch.float32),
    ), torch.tensor(terminal)


def _to(inp, dev):
    return {k: v.to(dev) for k, v in inp.items()}


def _min_boundary_gap(inp, rands, n_iters, accel):
    probs = search.node_probs(inp["logits"], inp["n_edge"], inp["w_edge"], inp["c_puct"],
                              inp["q_bounds"], n_iters=n_iters, accel=accel).double()
    cum = probs.cumsum(-1)  # (B,T,A)
    return float((cum[:, None] - rands.double()[..., None]).abs().min())


def _walk_inputs(seed, K):
    B, T, A = 16, 12, 7
    inp, terminal = _random_tree(seed, B, T, A)
    rands = torch.rand((B, K, T), generator=torch.Generator().manual_seed(seed))
    a, c = kernels.node_actions_multi_ref(rands=rands, **inp)  # (B,K,T)
    return terminal, a.permute(1, 0, 2).reshape(K * B, T), c.permute(1, 0, 2).reshape(K * B, T)


@pytest.mark.gpu
@pytest.mark.parametrize("K,max_levels", [(1, None), (4, None), (4, 3)])
def test_walk_kernel_matches_ref(cuda, K, max_levels):
    terminal, acts, nxt = _walk_inputs(6, K)
    ref = kernels.walk_ref(terminal, acts, nxt, max_levels=max_levels)
    n0 = kernels.walk.launches
    out = kernels.walk(terminal.to(cuda), acts.to(cuda), nxt.to(cuda), max_levels=max_levels)
    torch.cuda.synchronize()
    assert kernels.walk.launches == n0 + 1
    for r, o in zip(ref, out):
        assert o.dtype == torch.int32
        assert torch.equal(o.cpu(), r)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [
    (9, 1.0, 16, False), (2, 0.0625, 16, False), (9, 1.0, 6, True), (2, 0.0625, 6, True)])
def test_node_actions_multi_kernel_matches_ref(cuda, seed, c_puct, n_iters, accel):
    B, T, A, K = 16, 12, 7, 4
    inp, _ = _random_tree(seed, B, T, A, c_puct)
    rands = torch.rand((B, K, T), generator=torch.Generator().manual_seed(seed))
    assert _min_boundary_gap(inp, rands, n_iters, accel) > 1e-6
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, n_iters=n_iters, accel=accel,
                                                    return_alpha=True, **inp)
    n0 = kernels.node_actions_multi.launches
    ka, kc, kalpha = kernels.node_actions_multi(rands=rands.to(cuda), n_iters=n_iters,
                                                accel=accel, return_alpha=True, **_to(inp, cuda))
    torch.cuda.synchronize()
    assert kernels.node_actions_multi.launches == n0 + 1
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    assert torch.equal(ka.cpu(), ra)
    assert torch.equal(kc.cpu(), rc)


@pytest.mark.gpu
def test_node_actions_multi_kernel_wide_rows_and_slice(cuda):
    # 81 actions spread over three lane groups, and a leading-row slice of the
    # node axis as the grow passes hand it over (env stride > rows * A)
    B, T, A, K, R = 8, 20, 81, 8, 9
    inp, _ = _random_tree(4, B, T, A, c_puct=1 / 16)
    rands = torch.rand((B, K, R), generator=torch.Generator().manual_seed(4))
    sliced = {k: (v[:, :R] if v.dim() == 3 else v) for k, v in _to(inp, cuda).items()}
    ka, kc, kalpha = kernels.node_actions_multi(rands=rands.to(cuda), return_alpha=True, **sliced)
    ref = {k: (v[:, :R].contiguous() if v.dim() == 3 else v) for k, v in inp.items()}
    assert _min_boundary_gap(ref, rands, 6, True) > 1e-6
    ra, rc, ralpha = kernels.node_actions_multi_ref(rands=rands, return_alpha=True, **ref)
    torch.cuda.synchronize()
    torch.testing.assert_close(kalpha.cpu(), ralpha, rtol=1e-5, atol=0)
    assert torch.equal(ka.cpu(), ra)
    assert torch.equal(kc.cpu(), rc)


@pytest.mark.gpu
def test_wrappers_raise_on_wrong_inputs(cuda):
    terminal, acts, nxt = _walk_inputs(6, 2)
    with pytest.raises(ValueError):
        kernels.walk(terminal.to(cuda), acts.to(cuda).long(), nxt.to(cuda))
    inp, _ = _random_tree(1, 4, 6, 7)
    bad = _to(inp, cuda)
    bad["n_edge"] = bad["n_edge"].float()  # the kernel reads bf16 counts as stored
    with pytest.raises(ValueError):
        kernels.node_actions_multi(rands=torch.rand((4, 2, 6), device=cuda), **bad)
