"""The JAX flagship's bf16 configuration in the port, against the JAX package
on the CPU: a bf16 network (`FCModel(dtype=torch.bfloat16)`, JAX
`dtype=jnp.bfloat16`) and bf16 tree logits (`MCTSConfig.tree_dtype`).

* `FCModel(n_seats=1|2, dtype=bf16)` against flax's, fed the flax weights
  (one width-32, depth-2 model, ReZero alphas set non-zero): against the
  eager `model.apply`, which rounds to bf16 after every op as the port does,
  logits agree to atol 1.9e-6 and v to 2.4e-7 (f32 roundoff of the float32
  heads); against the jitted apply, which XLA compiles with other roundings,
  logits to atol 2e-2 and v to atol 4.5e-3. Each tolerance is at most 4x the
  largest difference measured over six seeds (4.8e-7, 6.0e-8; 5.4e-3,
  1.2e-3).
* The K=1, K=8 grow and K=8 scan searches with bf16 tree logits against
  JAX's at `tree_dtype=jnp.bfloat16`, both fed one float32 evaluator (the
  same converted FCModel), so that no bf16 network roundoff can flip a draw:
  the evaluator's logits round to bf16 to nearest even on both sides, and
  the trees meet the rules of the float32 search tests (topology, visit
  counts and the bf16 logits equal, values to atol 1e-5). `root()`'s prior
  holds -9984 (the -1e4 proxy in bf16) at invalid actions on both sides.
  The scan case runs the split kernels' twins against the Pallas
  `solve_probs`, which streams the bf16 rows, and `sample_children_multi`.
* The four kernels that read the tree's logits, through their twins on bf16
  logits, against the Pallas kernels in interpret mode on the same bf16
  tree: draws and child pointers equal, probs and alpha to rtol 1e-5; each
  twin on bf16 logits equals itself on their float32 copy bit for bit.
* One bf16/bf16 `train_step` from a converted JAX `TrainState` (boardsize
  3, width 16, depth 2, K=1): record, worlds and counters equal, every aux
  entry, the gradients and the updated parameters to the tolerances stated
  there.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu import train as jtrain
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.mcts import pallas_kernels as PK
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import kernels, search as TS
from boardlaw_tpu_torch.models import convert
from boardlaw_tpu_torch.models.networks import FCModel
from test_torch_kernels import _min_boundary_gap, _port_inputs, _random_tree
from test_torch_search import _models, _port_tree, _t, _worlds
from test_torch_search_k1 import JaxK1Draws
from test_torch_search_scan import run_case
from test_torch_train import JaxTrainDraws, _np

torch.set_num_threads(2)

BF16_PROXY = -9984.0  # search.NEG_INF_PROXY rounded to bf16


# --------------------------------------------------------------------------
# The bf16 network
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_net():
    """Flax bf16 FCModel weights (non-zero alphas, noised biases) and the
    worlds to evaluate, at 5x5, width 32, depth 2."""
    world = jhex.Hex.initial(1, 5)
    jmodel = JFCModel(world.obs_space, world.action_space, width=32, depth=2,
                      dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(1), world.obs, world.valid, world.seats)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.float32(rng.normal(0, 0.5)) if path[-1].key == "alpha"
        else np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), params)
    return params, _worlds(5, 32, 8, 1)


@pytest.mark.parametrize("n_seats", [1, 2])
def test_fcmodel_bf16_matches_flax(bf16_net, n_seats):
    params, jworld = bf16_net
    world = jhex.Hex.initial(1, 5)
    jmodel = JFCModel(world.obs_space, world.action_space, width=32, depth=2, n_seats=n_seats,
                      dtype=jnp.bfloat16)
    args = (params, jworld.obs, jworld.valid, jworld.seats)
    eager, jitted = jmodel.apply(*args), jax.jit(jmodel.apply)(*args)

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    model = FCModel(tworld.obs_space, tworld.action_space, width=32, depth=2, n_seats=n_seats,
                    dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(convert.from_flax(params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(tworld.obs, tworld.valid, tworld.seats)
    assert out["logits"].dtype == out["v"].dtype == torch.float32
    assert out["v"].shape == (32, n_seats)

    tl, tv = out["logits"].numpy(), out["v"].numpy()
    for want, atol_l, atol_v in ((eager, 1.9e-6, 2.4e-7), (jitted, 2e-2, 4.5e-3)):
        jl = np.asarray(want["logits"])
        np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
        fin = np.isfinite(jl)
        np.testing.assert_allclose(tl[fin], jl[fin], rtol=0, atol=atol_l)
        np.testing.assert_allclose(tv, np.asarray(want["v"]), rtol=0, atol=atol_v)


# --------------------------------------------------------------------------
# Searches on bf16 tree logits
# --------------------------------------------------------------------------

def _assert_bf16_prior(tprior, jprior):
    """root()'s prior from bf16 logits: equal on both sides, finite, -9984
    exactly where the proxy was stored."""
    t, j = tprior.numpy(), np.asarray(jprior, np.float32)
    np.testing.assert_array_equal(t, j)
    assert np.isfinite(t).all() and (t == BF16_PROXY).any()


def test_k1_search_bf16_tree_matches_jax():
    B, n_nodes, seed, plies = 16, 17, 21, 4
    jeval, teval = _models(seed=seed)
    jworld = _worlds(5, B, plies, seed)
    key = jax.random.PRNGKey(seed)
    jcfg = S.MCTSConfig(n_nodes=n_nodes, use_pallas=False, pallas_nodes=False, pallas_walk=False,
                        tree_dtype=jnp.bfloat16)

    def search(w, k):
        tree = S.mcts(w, jeval, k, jcfg)
        return tree, S.root(tree)

    jt, jroot = jax.jit(search)(jworld, key)
    assert jt.logits.dtype == jnp.bfloat16

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tcfg = TS.MCTSConfig(n_nodes=n_nodes, tree_dtype=torch.bfloat16)
    tt = TS.mcts(tworld, teval, JaxK1Draws(key, n_nodes - 1), tcfg)
    assert tt.logits.dtype == torch.bfloat16

    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64), err_msg=name)
    for name in ("n_edge", "logits"):
        np.testing.assert_array_equal(getattr(tt, name).float().numpy(),
                                      np.asarray(getattr(jt, name), np.float32), err_msg=name)
    for name in ("w", "w_edge", "v", "rewards"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   atol=1e-5, err_msg=name)
    troot = TS.root(tt)
    _assert_bf16_prior(troot["prior"], jroot["prior"])
    jl, tl = np.asarray(jroot["logits"]), troot["logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    np.testing.assert_allclose(tl[np.isfinite(jl)], jl[np.isfinite(jl)], atol=1e-5)


@pytest.mark.parametrize("name,seed,plies,tkw,jkw", [
    ("grow", 51, 6, dict(grow_passes=True),
     dict(grow_passes=True, sample_cum="shift")),
    ("scan", 52, 7, dict(solve_kernel="probs", sample_kernel=True),
     dict(pallas_solve="interpret", pallas_sample="interpret", pallas_sample_envs=8)),
])
def test_k8_search_bf16_tree_matches_jax(monkeypatch, name, seed, plies, tkw, jkw):
    # K=8, 17 nodes: two passes; run_case also checks that no uniform lies
    # within 1e-6 of a CDF boundary, then the float32 search tests' rules
    tt, jt = run_case(monkeypatch, seed, plies, dict(tree_dtype=torch.bfloat16, **tkw),
                      dict(tree_dtype=jnp.bfloat16, **jkw), n_nodes=17, k=8)
    assert tt.logits.dtype == torch.bfloat16 and jt.logits.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tt.logits.float().numpy(), np.asarray(jt.logits, np.float32))
    _assert_bf16_prior(TS.root(tt)["prior"], jax.jit(S.root)(jt)["prior"])


def test_tree_dtype_is_float32_or_bfloat16():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError):
            TS.MCTSConfig(tree_dtype=dtype)
    assert train.make_config(9, 512, 4, tree_dtype="bfloat16").mcts_config().tree_dtype \
        == torch.bfloat16
    # the kernels' wrappers refuse other logits before looking at the device
    inp = _port_inputs(_random_tree(np.random.default_rng(0), 2, 4, 3))
    with pytest.raises(ValueError, match="^logits must be float32 or bfloat16"):
        kernels._check_tree_rows(inp["logits"].half(), inp["n_edge"], inp["w_edge"], None, 2, 4, 3)


# --------------------------------------------------------------------------
# The kernels' twins on bf16 logits against the Pallas kernels
# --------------------------------------------------------------------------

def _bf16_case(seed, c_puct, B=16, T=12, A=7):
    """A random JAX tree with bf16 logits, and its port inputs: the same
    logits as a bf16 tensor."""
    tree = _random_tree(np.random.default_rng(seed), B, T, A, c_puct=c_puct)
    tree = S.Tree(**{**tree.__dict__, "logits": tree.logits.astype(jnp.bfloat16)})
    f32 = S.Tree(**{**tree.__dict__, "logits": tree.logits.astype(jnp.float32)})
    inp = _port_inputs(f32)
    inp["logits"] = inp["logits"].bfloat16()  # exact: the values are bf16's
    return tree, f32, inp


def _twin_on_f32_copy(fn, inp, **kw):
    """`fn` on bf16 logits and on their float32 copy: equal bit for bit."""
    out = fn(**inp, **kw)
    again = fn(**{**inp, "logits": inp["logits"].float()}, **kw)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)
    return out


@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [(0, 1.0, 16, False), (9, 1.0, 6, True)])
def test_node_actions_multi_twin_on_bf16_matches_pallas(seed, c_puct, n_iters, accel):
    tree, _, inp = _bf16_case(seed, c_puct)
    K, B, T = 4, 16, 12
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (K, B, T))
    qb = S._q_bounds(tree)
    assert _min_boundary_gap(tree, qb, rands, n_iters, accel) > 1e-6
    ja, jc = PK.node_actions_multi(tree, jnp.moveaxis(rands, 0, 1), qb, block_envs=8,
                                   interpret=True, n_iters=n_iters, accel=accel)
    ta, tc = _twin_on_f32_copy(kernels.node_actions_multi, inp, rands=_t(jnp.moveaxis(rands, 0, 1)),
                               n_iters=n_iters, accel=accel)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (1, 0.0625)])
def test_node_actions_twin_on_bf16_matches_pallas(seed, c_puct):
    tree, _, inp = _bf16_case(seed, c_puct)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (16, 12))
    qb = S._q_bounds(tree)
    assert _min_boundary_gap(tree, qb, rands[None], 16, False) > 1e-6
    pa, pc = PK.node_actions(tree, rands, qb, block_envs=8, interpret=True)
    ta, tc = _twin_on_f32_copy(kernels.node_actions, inp, rands=_t(rands))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))


@pytest.mark.parametrize("seed,c_puct", [(0, 1.0), (2, 10.0)])
def test_descend_twin_on_bf16_matches_pallas(seed, c_puct):
    tree, f32, inp = _bf16_case(seed, c_puct)
    rands = jax.random.uniform(jax.random.PRNGKey(seed), (16, 12))
    assert _min_boundary_gap(tree, S._q_bounds(tree), rands[None], 16, False) > 1e-6
    pp, pa = PK.descend(tree, rands, block_envs=8, interpret=True)
    ttree = dataclasses.replace(_port_tree(f32), logits=inp["logits"])
    tp, ta = kernels.descend(ttree, _t(rands))  # CPU: search.descend_reference
    fp, fa = kernels.descend(_port_tree(f32), _t(rands))
    assert torch.equal(tp, fp) and torch.equal(ta, fa)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(pa))
    # the default route (node_actions + walk twins) gives the same walk
    dp, da = TS.descend(ttree, _t(rands))
    assert torch.equal(dp, tp) and torch.equal(da, ta)


@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [(0, 1.0, 6, True), (2, 0.0625, 16, False)])
def test_solve_probs_twin_on_bf16_matches_pallas(seed, c_puct, n_iters, accel):
    # the Pallas kernel streams the bf16 rows and upcasts inside
    tree, _, inp = _bf16_case(seed, c_puct)
    qb = S._q_bounds(tree)
    del inp["children"]
    for out in ("probs", "alpha"):
        jres = PK.solve_probs(tree, qb, n_iters=n_iters, accel=accel, interpret=True, out=out)
        tres = _twin_on_f32_copy(kernels.solve_probs, inp, n_iters=n_iters, accel=accel, out=out)
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-5, atol=1e-7,
                                   err_msg=out)


# --------------------------------------------------------------------------
# One bf16/bf16 train step
# --------------------------------------------------------------------------

def test_train_step_bf16_matches_jax():
    """Tolerances, each at most 4x the largest difference measured over
    three seeds (seeds 5-7): the record as in the float32 test (equal here);
    aux entries to rtol 8e-4, atol 1e-6 (measured: relative 2.0e-4, on
    grad.norm); gradients to atol 1.6e-2 (3.9e-3: one bf16 step at 0.5, the
    jitted JAX step rounds its bf16 products in other places); the updated
    parameters to atol 2.4e-7 where both gradients exceed 1.6e-2 (6.0e-8),
    else to lr, Adam's first step."""
    kw = dict(n_envs=8, buffer_len=4, mix_steps=16, dtype="bfloat16", tree_dtype="bfloat16")
    jcfg = jtrain.TrainConfig(boardsize=3, width=16, depth=2, n_nodes=8, **kw)
    tcfg = train.make_config(3, 16, 2, nodes=8, **kw)
    assert tcfg.compute_dtype == torch.bfloat16
    _, _, init, warmup, train_step = jtrain.make_train(jcfg)
    jstate = warmup(init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    jstate = jstate.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, jstate.params))
    before = _np(jstate)

    tstate = convert.train_state_from_jax(before, tcfg, device="cpu")
    assert tstate.model.dtype == torch.bfloat16
    jnew, jaux = train_step(jstate)
    jnew, jaux = _np(jnew), _np(jaux)
    tnew, taux = train.train_step(tcfg, tstate, JaxTrainDraws(jnp.asarray(before.key), 7))

    assert (tnew.ptr, tnew.step) == (int(jnew.ptr), int(jnew.step))
    np.testing.assert_array_equal(tnew.worlds.board.numpy(), jnew.worlds.board)
    slot = int(before.ptr)
    for k in ("n_leaves", "terminal"):
        np.testing.assert_array_equal(tnew.buffer[k][slot].numpy(), jnew.buffer[k][slot], err_msg=k)
    for k in ("v", "rewards"):
        np.testing.assert_allclose(tnew.buffer[k][slot].numpy(), jnew.buffer[k][slot], atol=1e-5)
    for k in ("logits", "prior"):
        t = tnew.buffer[k][slot].float().numpy()
        j = np.asarray(jnew.buffer[k][slot], np.float32)
        np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=2 ** -7, atol=1e-5, err_msg=k)
    assert (tnew.buffer["prior"][slot].float() == BF16_PROXY).any()

    assert set(taux) == set(jaux)
    for k in sorted(jaux):
        assert torch.isfinite(torch.as_tensor(taux[k])).all(), k
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=8e-4, atol=1e-6,
                                   err_msg=k)

    adam = jnew.opt_state[0]
    jgrads = {k: v / 0.1 for k, v in convert.from_flax(adam.mu).items()}
    jparams = convert.from_flax(jnew.params)
    for name, p in tnew.model.named_parameters():
        g, want = jgrads[name].reshape(p.shape), jparams[name].reshape(p.shape)
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad, g, rtol=0, atol=1.6e-2, msg=name)
        big = (g.abs() > 1.6e-2) & (p.grad.abs() > 1.6e-2)
        torch.testing.assert_close(p.detach()[big], want[big], rtol=0, atol=2.4e-7, msg=name)
        torch.testing.assert_close(p.detach()[~big], want[~big], rtol=0, atol=tcfg.lr, msg=name)
