"""The wide tree's K=8 searches against the JAX package's, on the CPU, on
4x4 with the same converted FCModel on both sides and JAX's draws injected
through the port's `Draws` seam:

* the scan search at `n_nodes` = 300 (T = 305 node slots: int32 children,
  float32 edge counts) through the port's split route (the `solve_probs`
  and `sample_children_multi` twins), against JAX's XLA solve and 'shift'
  sampler;
* the grow-pass search at `n_nodes` = 122 (T = 129, the first grow tree
  with float32 counts) through the fused route (the `node_actions_multi`
  twin). JAX unrolls its grow passes, one graph a pass: at `n_nodes` = 300
  its jit takes minutes on the CPU, so the card runs that size (chip_smoke.py
  phase 8, against the port's CPU search).

Each case first checks that no uniform lies within 1e-7 of a CDF boundary
of the port's solved probs (about one float32 ulp at 1: over some 10^5
draws the closest comes within a few ulps); then `children`, `parents`,
`n`, `n_edge` and the leaf worlds are bit-equal and value sums, values,
logits and cumulative rewards agree to atol 1e-5 (float32 sums in another
order). The K=1 search and the kernel twins on wide trees are in
tests/test_torch_wide_tree.py.
"""
import jax
import pytest
import torch

from boardlaw_tpu.mcts import search as S
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import search as TS
from test_torch_search import _models, _t, _worlds
from test_torch_search_scan import BoundaryGaps, JaxScanDraws
from test_torch_wide_tree import assert_same_search

torch.set_num_threads(2)

K = 8


@pytest.mark.parametrize("name,n_nodes,B,tkw,jkw", [
    ("scan split", 300, 2, dict(solve_kernel="probs", sample_kernel=True), dict()),
    ("grow", 122, 4, dict(grow_passes=True), dict(grow_passes=True)),
])
def test_wide_k8_search_matches_jax(monkeypatch, name, n_nodes, B, tkw, jkw):
    seed = 41
    jeval, teval = _models(boardsize=4, seed=seed)
    jworld = _worlds(4, B, 2, seed)
    key = jax.random.PRNGKey(seed)
    jcfg = S.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K, use_pallas=False, pallas_walk=False,
                        sample_cum="shift", **jkw)
    jt = jax.jit(lambda w, k: S.mcts(w, jeval, k, jcfg))(jworld, key)

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tcfg = TS.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K, **tkw)
    assert TS.tree_size(tcfg) > 128
    gaps = BoundaryGaps(monkeypatch)
    tt = TS.mcts(tworld, teval, JaxScanDraws(key, tcfg.n_passes, grow=tcfg.grow_passes), tcfg)
    assert gaps.gap > 1e-7, gaps.gap
    assert tt.children.dtype == torch.int32 and tt.n_edge.dtype == torch.float32
    assert_same_search(tt, jt, n_nodes)
    assert (tt.n[:, 0] == 2 * K * tcfg.n_passes).all()
