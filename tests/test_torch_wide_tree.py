"""The wide search tree (`n_nodes` > 127) against the JAX package, on the CPU.

* `build` keeps JAX's dtype rule (its default `compact=True`): int8
  children up to 127 node slots, int32 above; bf16 edge counts while
  2T <= 256, float32 above.
* The K=1 search at `n_nodes` 128 (int32 children, bf16 counts) and 200
  (int32, float32) on 3x3 against the JAX package's XLA route under the same
  draws: `children`, `parents`, `n`, `n_edge` and the leaf worlds bit-equal,
  value sums, values and logits to atol 1e-5 (float32 sums in another
  order).
* Each kernel's twin on int32/float32 trees of 300 slots against its Pallas
  kernel in interpret mode, by the rules of tests/test_torch_kernels.py: the
  draws and child pointers bit-equal (each case checks that no uniform lies
  within 1e-6 of a CDF boundary), solved probs to rtol 1e-5, backups n exact
  and w/n_edge/w_edge to atol 1e-5.
* The Pallas `sample_children_multi` streams child pointers as bf16, exact up
  to 256 only: at T = 305 its pointers above 256 are rounded, where the XLA
  sampler's and the port's twin's are exact (a note on the reference,
  ROADMAP.md section 3).

The K=8 grow and scan searches at `n_nodes` = 300 are in
tests/test_torch_wide_tree_multi.py, so that the two files' JAX compiles run
on separate workers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.mcts import pallas_kernels as PK, search as S
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import kernels, search as TS
from test_torch_kernels import _min_boundary_gap, _random_tree
from test_torch_search import _models, _t, _worlds
from test_torch_search_k1 import JaxK1Draws

torch.set_num_threads(2)

TORCH = {"int8": torch.int8, "int32": torch.int32, "bfloat16": torch.bfloat16,
         "float32": torch.float32}


def _same_dtype(tdt, jdt):
    return tdt == TORCH[str(np.dtype(jdt))]


def wide_port_tree(jt):
    """A JAX tree's arrays as a port Tree, children and n_edge in the JAX
    tree's own types."""
    return TS.Tree(
        children=_t(jt.children).to(TORCH[str(jt.children.dtype)]), parents=_t(jt.parents),
        relation=_t(jt.relation), worlds=None, seats=_t(jt.seats), terminal=_t(jt.terminal),
        rewards=_t(jt.rewards), logits=_t(jt.logits), v=_t(jt.v), n=_t(jt.n), w=_t(jt.w),
        n_edge=_t(np.asarray(jt.n_edge, np.float32)).to(TORCH[str(jt.n_edge.dtype)]),
        w_edge=_t(jt.w_edge), c_puct=_t(jt.c_puct), sim=int(jt.sim), prew=None)


def assert_same_search(tt, jt, n_nodes):
    assert tt.sim == int(jt.sim) == tt.children.shape[1]  # every node slot filled
    assert _same_dtype(tt.children.dtype, jt.children.dtype)
    assert _same_dtype(tt.n_edge.dtype, jt.n_edge.dtype)
    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(jt.n_edge, np.float32))
    np.testing.assert_array_equal(tt.worlds.board.numpy(), np.asarray(jt.worlds.board))
    for name in ("w", "w_edge", "v", "rewards", "logits", "prew"):
        t, j = getattr(tt, name), getattr(jt, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=1e-5,
                                       err_msg=name)
    # node ids at the top of the tree (past int8's range above 128 nodes)
    assert int(tt.children.max()) >= min(n_nodes - 1, 200)


# tree sizes T on both sides of each boundary: 127 | 128 (int8 | int32
# children), 128 | 129 (bf16 | f32 counts), and K=8 trees (T = 1 + 8 slots
# a pass: 17, 121, 129, 305, 513)
@pytest.mark.parametrize("n_nodes,K", [(2, 1), (64, 1), (126, 1), (127, 1), (128, 1),
                                       (129, 1), (130, 1), (256, 1), (257, 1), (305, 1),
                                       (16, 8), (120, 8), (122, 8), (128, 8), (300, 8),
                                       (512, 8)])
def test_build_dtypes_match_jax(n_nodes, K):
    jworld = jhex.Hex.initial(2, 3)
    jt = S.build(jworld, S.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K))
    cfg = TS.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K)
    tt = TS.build(thex.Hex.initial(2, 3, device="cpu"), cfg)
    assert tt.children.shape == jt.children.shape
    assert _same_dtype(tt.children.dtype, jt.children.dtype)
    assert _same_dtype(tt.n_edge.dtype, jt.n_edge.dtype)
    assert TS.tree_dtypes(cfg) == (tt.children.dtype, tt.n_edge.dtype)
    assert (tt.children == -1).all() and (tt.n_edge == 0).all()


@pytest.mark.parametrize("n_nodes", [128, 200])
def test_k1_search_matches_jax(n_nodes):
    B, seed = 4, 21
    jeval, teval = _models(boardsize=3, seed=seed)
    jworld = _worlds(3, B, 1, seed)
    key = jax.random.PRNGKey(seed)
    jcfg = S.MCTSConfig(n_nodes=n_nodes, use_pallas=False, pallas_nodes=False, pallas_walk=False)
    jt = jax.jit(lambda w, k: S.mcts(w, jeval, k, jcfg))(jworld, key)

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tt = TS.mcts(tworld, teval, JaxK1Draws(key, n_nodes - 1), TS.MCTSConfig(n_nodes=n_nodes))
    assert_same_search(tt, jt, n_nodes)
    assert (tt.n[:, 0] == 2 * (n_nodes - 1)).all()


def _wide_tree(seed, B=8, T=305, A=7):
    tree = _random_tree(np.random.default_rng(seed), B, T, A)
    tree = tree.replace(n_edge=tree.n_edge.astype(jnp.float32))
    assert tree.children.dtype == jnp.int32 and int(tree.children.max()) > 256
    return tree


def _inputs(tree):
    lo, hi = S._q_bounds(tree)
    return dict(logits=_t(tree.logits), n_edge=_t(tree.n_edge), w_edge=_t(tree.w_edge),
                children=_t(tree.children), c_puct=_t(tree.c_puct),
                q_bounds=torch.tensor([float(lo), float(hi)]))


def test_row_twins_match_pallas_on_wide_trees():
    tree = _wide_tree(0)
    B, T, A = tree.children.shape
    qb = S._q_bounds(tree)
    inp = _inputs(tree)
    assert inp["children"].dtype == torch.int32 and inp["n_edge"].dtype == torch.float32
    # node_actions_multi
    rands = jax.random.uniform(jax.random.PRNGKey(1), (4, B, T))
    assert _min_boundary_gap(tree, qb, rands, 6, True) > 1e-6
    ja, jc = PK.node_actions_multi(tree, jnp.moveaxis(rands, 0, 1), qb, block_envs=8,
                                   interpret=True, n_iters=6, accel=True)
    ta, tc = kernels.node_actions_multi(rands=_t(jnp.moveaxis(rands, 0, 1)), **inp)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.max()) > 256
    # solve_probs
    del inp["children"]
    for out in ("probs", "alpha"):
        jres = PK.solve_probs(tree, qb, n_iters=6, accel=True, interpret=True, out=out)
        tres = kernels.solve_probs(out=out, **inp)
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-5, atol=1e-7)
    # node_actions (K=1)
    r1 = jax.random.uniform(jax.random.PRNGKey(2), (B, T))
    assert _min_boundary_gap(tree, qb, r1[None], 16, False) > 1e-6
    pa, pc = PK.node_actions(tree, r1, qb, block_envs=8, interpret=True)
    ta, tc = kernels.node_actions(rands=_t(r1), **_inputs(tree))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
    # descend
    pp, pa = PK.descend(tree, r1, block_envs=8, interpret=True)
    tp, ta = kernels.descend(wide_port_tree(tree), _t(r1))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(pa))


@pytest.mark.parametrize("variant", ["delta", "dense"])
def test_backup_twins_match_pallas_on_wide_trees(variant):
    tree = _wide_tree(3)
    B, T, _ = tree.children.shape
    leaves = jnp.asarray(np.random.default_rng(3).integers(T // 2, T, B), jnp.int32)
    pallas = PK.backup if variant == "delta" else PK.backup_dense
    out = pallas(tree, leaves, 2, block_envs=8, interpret=True)
    wrapper = kernels.backup if variant == "delta" else kernels.backup_dense
    ttree = wrapper(wide_port_tree(tree), _t(leaves), 2)
    assert ttree.n_edge.dtype == torch.float32
    np.testing.assert_array_equal(ttree.n.numpy(), np.asarray(out.n))
    for name in ("w", "n_edge", "w_edge"):
        np.testing.assert_allclose(getattr(ttree, name).numpy(),
                                   np.asarray(getattr(out, name), np.float32), atol=1e-5,
                                   err_msg=name)


def test_walk_twin_matches_pallas_on_wide_trees():
    tree = _wide_tree(4)
    B, T, _ = tree.children.shape
    K = 8
    rands = jax.random.uniform(jax.random.PRNGKey(4), (K, B, T))
    probs = S.node_probs(tree, S._q_bounds(tree))
    acts, nxt = S._sample_children_multi(tree, probs, rands, cum_mode="shift")
    acts, nxt = np.asarray(acts).reshape(K * B, T), np.asarray(nxt).reshape(K * B, T)
    jp = PK.walk(tree.terminal, jnp.asarray(acts), jnp.asarray(nxt), block_envs=8,
                 interpret=True)
    tp = kernels.walk(_t(tree.terminal), _t(acts), _t(nxt))
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pallas_sampler_rounds_child_ids_above_256():
    # the reference's Pallas sampler streams children as bf16: ids above 256
    # come back rounded (257 -> 256, 259 -> 260); the XLA sampler and the
    # port's twin return them exactly
    tree = _wide_tree(5)
    B, T, _ = tree.children.shape
    rands = jax.random.uniform(jax.random.PRNGKey(5), (B, 8, T))
    probs = S.node_probs(tree, S._q_bounds(tree))
    pa, pc = PK.sample_children_multi(probs, tree.children, rands, block_envs=8, interpret=True)
    xa, xc = S._sample_children_multi(tree, probs, jnp.moveaxis(rands, 1, 0), cum_mode="shift")
    xa, xc = np.moveaxis(np.asarray(xa), 0, 1), np.moveaxis(np.asarray(xc), 0, 1)
    ta, tc = kernels.sample_children_multi(_t(probs), _t(tree.children), _t(rands))
    np.testing.assert_array_equal(np.asarray(pa), xa)  # the same draws
    np.testing.assert_array_equal(ta.numpy(), xa)
    np.testing.assert_array_equal(tc.numpy(), xc)  # the port: exact pointers
    wrong = np.asarray(pc) != xc
    assert wrong.any() and (xc[wrong] > 256).all()
    np.testing.assert_array_equal(np.asarray(pc)[wrong],
                                  np.asarray(jnp.asarray(xc[wrong]).astype(jnp.bfloat16)
                                             .astype(jnp.int32)))
