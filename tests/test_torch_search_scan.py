"""The port's K>1 search in scan mode (every pass over all T rows) and its
split solve and sampler routes against the JAX package's, on 5x5 with B=8,
n_nodes=13, K=4: the same converted FCModel on both sides and JAX's draws
injected through the port's `Draws` seam.

Each route of the port is held against the JAX configuration that runs the
same formulation; the Pallas kernels run in interpret mode, the port's
kernels as their CPU twins. Each case first checks that no uniform of any
pass lies within 1e-6 of a CDF boundary of the port's solved probs (the
sums of the two sides differ in the last bits, which could flip such a
draw). Then topology and visit counts (`children`, `parents`, `n`,
`n_edge`) are bit-equal, and value sums, net values, cumulative rewards and
warm-start roots agree to atol 1e-5.

The kernel routes ('probs', 'alpha', `sample_kernel`) are in
tests/test_torch_search_scan_kernels.py, so that the two files' JAX compiles
run on separate workers.
"""
import functools

import numpy as np
import jax
import pytest
import torch

from boardlaw_tpu.mcts import search as S
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import kernels, search as TS
from test_torch_search import JaxDraws, _models, _t, _worlds

torch.set_num_threads(2)

B, N_NODES, K = 8, 13, 4


class JaxScanDraws(JaxDraws):
    """JaxDraws with the scan's per-pass uniforms: pass p takes key p of
    split(k_sims, n_passes) and draws with the first half of its split.
    `grow=True` keeps JaxDraws' grow-pass `fold_in` keys."""

    def __init__(self, key, n_passes, grow=False):
        super().__init__(key)
        self.n_passes = n_passes
        self.grow = grow

    def pass_rands(self, p, shape):
        if self.grow:
            return super().pass_rands(p, shape)
        k_rand, _ = jax.random.split(jax.random.split(self.k_sims, self.n_passes)[p])
        return torch.tensor(np.asarray(jax.random.uniform(k_rand, tuple(shape))))


@functools.lru_cache(maxsize=None)
def _jax_search(seed, plies, jkw, n_nodes=N_NODES, k=K):
    jeval, _ = _models(seed=seed)
    jworld = _worlds(5, B, plies, seed)
    jcfg = S.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=k, use_pallas=False, pallas_walk=False,
                        **dict(jkw))
    return jax.jit(lambda w, k: S.mcts(w, jeval, k, jcfg))(jworld, jax.random.PRNGKey(seed))


class BoundaryGaps:
    """The least |cum - r| over every draw of a search, cum the float64
    prefix sum of the port's solved probs, recorded at both samplers."""

    def __init__(self, monkeypatch):
        self.gap = np.inf
        sampler, kernel = TS._sample_children_multi, kernels.sample_children_multi

        def record(probs, rands_kbt):
            cum = probs.double().cumsum(-1)
            self.gap = min(self.gap, float((cum[None] - rands_kbt.double()[..., None]).abs().min()))

        def torch_sampler(children, probs, rands, cum_mode="shift"):
            record(probs, rands)
            return sampler(children, probs, rands, cum_mode)

        def kernel_sampler(probs, children, rands):
            record(probs, rands.permute(1, 0, 2))
            return kernel(probs, children, rands)

        def fused(logits, n_edge, w_edge, children, rands, c_puct, q_bounds, n_iters, accel):
            record(TS.node_probs(logits, n_edge, w_edge, c_puct, q_bounds, n_iters, accel),
                   rands.permute(1, 0, 2))
            return kernels.node_actions_multi_ref(logits, n_edge, w_edge, children, rands, c_puct,
                                                  q_bounds, n_iters, accel)

        monkeypatch.setattr(TS, "_sample_children_multi", torch_sampler)
        monkeypatch.setattr(kernels, "sample_children_multi", kernel_sampler)
        monkeypatch.setattr(kernels, "node_actions_multi", fused)


def run_case(monkeypatch, seed, plies, tkw, jkw, n_nodes=N_NODES, k=K):
    """The port's search under `tkw` against the JAX package's under `jkw`,
    with `n_nodes` nodes and `k` leaves a pass."""
    jt = _jax_search(seed, plies, tuple(sorted(jkw.items())), n_nodes, k)
    _, teval = _models(seed=seed)
    jworld = _worlds(5, B, plies, seed)
    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tcfg = TS.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=k, **tkw)
    gaps = BoundaryGaps(monkeypatch)
    tt = TS.mcts(tworld, teval, JaxScanDraws(jax.random.PRNGKey(seed), tcfg.n_passes,
                                             grow=tcfg.grow_passes), tcfg)
    assert gaps.gap > 1e-6, gaps.gap

    assert tt.sim == int(jt.sim) == n_nodes
    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(jt.n_edge, np.float32))
    np.testing.assert_array_equal(tt.worlds.board.numpy(), np.asarray(jt.worlds.board))
    for name in ("w", "w_edge", "v", "rewards", "logits", "prew", "alpha"):
        t, j = getattr(tt, name), getattr(jt, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=1e-5,
                                       err_msg=name)
    # the root gets 2 visits (one per seat) from every draw of every pass
    assert (tt.n[:, 0] == 2 * k * tcfg.n_passes).all()
    return tt, jt


@pytest.mark.parametrize("name,seed,plies,tkw,jkw", [
    ("ops+shift", 31, 7, dict(solve_kernel="ops", sample_cum="shift"), dict(sample_cum="shift")),
    ("fused", 31, 7, dict(), dict(sample_cum="shift")),
    ("ops+matmul", 32, 5, dict(solve_kernel="ops"), dict()),
    ("einsum", 33, 9, dict(solve_kernel="ops", backup_mode="einsum"), dict(backup_mode="einsum")),
    ("warm", 34, 6, dict(solve_kernel="ops", warm_solve=True), dict(warm_solve=True)),
    ("grow+matmul", 36, 8, dict(solve_kernel="ops", grow_passes=True), dict(grow_passes=True)),
])
def test_scan_search_matches_jax(monkeypatch, name, seed, plies, tkw, jkw):
    tt, _ = run_case(monkeypatch, seed, plies, tkw, jkw)
    assert (tt.prew is None) == (tkw.get("backup_mode") == "einsum"), name
    assert (tt.alpha is not None) == tkw.get("warm_solve", False), name


def test_dummy_agent_matches_jax():
    jeval, teval = _models(seed=3)
    jworld = _worlds(5, B, 4, 3)
    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    key = jax.random.PRNGKey(3)

    class GumbelDraws(JaxDraws):
        def gumbel(self, shape):
            return torch.tensor(np.asarray(jax.random.gumbel(key, tuple(shape))))

    jout = S.DummyAgent(jeval)(jworld, key)
    tout = TS.DummyAgent(teval)(tworld, GumbelDraws(key))
    np.testing.assert_array_equal(tout["actions"].numpy(), np.asarray(jout["actions"]))
    for k in ("n_sims", "n_leaves"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_allclose(tout["v"].numpy(), np.asarray(jout["v"]), atol=1e-5)
    greedy = TS.DummyAgent(teval)(tworld, eval=True)
    assert torch.equal(greedy["actions"], torch.argmax(tout["logits"], -1).to(torch.int32))
    assert tworld.valid[torch.arange(B), tout["actions"].long()].all()
