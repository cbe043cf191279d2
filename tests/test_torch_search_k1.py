"""The port's sequential K=1 search against the JAX package's.

* The port's `MCTSConfig` and `TrainConfig` defaults are the JAX package's
  (K=1, no grow passes), and `MCTSAgent(eval_fn)` runs the K=1 search.
* A whole K=1 search on 5x5 (B=16, 17 nodes) against the JAX package's XLA
  route (`use_pallas=False, pallas_nodes=False, pallas_walk=False`), with the
  same converted FCModel and JAX's draws injected: topology and visit counts
  (`children`, `parents`, `n`, `n_edge`) equal, `w`/`w_edge` to atol 1e-5.
  JAX's XLA sampler sums with `jnp.cumsum` where the port uses the log-shift
  order; on these seeds no draw lies at a CDF boundary, so the draws agree.
* Ports of tests/test_mcts.py's `test_descend_matches_reference_walk` and
  `test_backup_path_matches_backup`, and the three kernel variants
  (`descend_kernel` with each `backup_kernel`) against the default route
  with `backup_kernel='ops'`, all through the wrappers' CPU twins.
* The backup `simulate` calls on each route, for each `backup_kernel`, on a
  tree on the card or the CPU; a tree on the card with more seats than the
  backup kernels take is refused.
"""
import contextlib
import dataclasses

import numpy as np
import jax
import pytest
import torch

from boardlaw_tpu import train as jtrain
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.envs import validation as V
from boardlaw_tpu_torch.mcts import kernels
from boardlaw_tpu_torch.mcts import search as TS
from test_torch_search import JaxDraws, _models, _t, _worlds

torch.set_num_threads(2)


class JaxK1Draws(JaxDraws):
    """JaxDraws plus the per-sim uniforms of the K=1 scan: sim i takes key
    i of split(k_sims, n_sims) and draws with the first half of its split."""

    def __init__(self, key, n_sims):
        super().__init__(key)
        self.n_sims = n_sims

    def sim_rands(self, i, shape):
        k_rand, _ = jax.random.split(jax.random.split(self.k_sims, self.n_sims)[i])
        return torch.tensor(np.asarray(jax.random.uniform(k_rand, tuple(shape))))


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING}


def _same_default(mine, theirs):
    """Equal defaults; a dtype-valued one (a torch dtype against a JAX or
    numpy dtype) by its name."""
    if isinstance(mine, torch.dtype):
        return str(mine).removeprefix("torch.") == str(np.dtype(theirs))
    return mine == theirs


def test_defaults_match_jax(monkeypatch):
    for port, ref, must in ((TS.MCTSConfig, S.MCTSConfig,
                             {"leaves_per_pass", "grow_passes", "tree_dtype"}),
                            (train.TrainConfig, jtrain.TrainConfig,
                             {"leaves_per_pass", "grow_passes", "lr", "buffer_len", "seed",
                              "dtype", "tree_dtype"})):
        mine, theirs = _defaults(port), _defaults(ref)
        shared = mine.keys() & theirs.keys()
        assert must <= shared
        for name in shared:
            assert _same_default(mine[name], theirs[name]), (port.__name__, name)
    assert not _same_default(torch.bfloat16, S.MCTSConfig.tree_dtype)

    # MCTSAgent(eval_fn) runs the sequential search: n_nodes - 1 K=1 sims
    calls = []
    monkeypatch.setattr(TS, "simulate", lambda tree, *a: calls.append(tree.sim))
    monkeypatch.setattr(TS, "simulate_multi", None)
    _, teval = _models()
    agent = TS.MCTSAgent(teval)
    agent(thex.Hex.initial(2, 5, device="cpu"), n_nodes=9)
    assert agent.cfg.leaves_per_pass == 1 and len(calls) == 8


@pytest.mark.parametrize("seed,plies", [(21, 4), (22, 9)])
def test_k1_search_matches_jax(seed, plies):
    B, n_nodes = 16, 17
    jeval, teval = _models(seed=seed)
    jworld = _worlds(5, B, plies, seed)
    key = jax.random.PRNGKey(seed)

    jcfg = S.MCTSConfig(n_nodes=n_nodes, use_pallas=False, pallas_nodes=False, pallas_walk=False)
    jt = jax.jit(lambda w, k: S.mcts(w, jeval, k, jcfg))(jworld, key)

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tt = TS.mcts(tworld, teval, JaxK1Draws(key, n_nodes - 1), TS.MCTSConfig(n_nodes=n_nodes))

    assert tt.sim == int(jt.sim) == n_nodes and tt.prew is None
    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(jt.n_edge, np.float32))
    np.testing.assert_array_equal(tt.worlds.board.numpy(), np.asarray(jt.worlds.board))
    for name in ("w", "w_edge", "v", "rewards", "logits"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name), np.float32),
                                   atol=1e-5, err_msg=name)
    # the root holds 2 visits (one per seat) from each of the 16 sims
    assert (tt.n[:, 0] == 2 * (n_nodes - 1)).all()


def _k1_tree(B, n_nodes, seed):
    _, teval = _models(seed=seed)
    world = thex.Hex.initial(B, 5, device="cpu")
    cfg = TS.MCTSConfig(n_nodes=n_nodes)
    tree = TS.build(world, cfg)
    tree = TS.initialize(tree, teval(world), Draws(seed, "cpu"), cfg, world.valid)
    return tree, teval, cfg


def test_descend_matches_reference_walk():
    # the default descend (all-node pass + pointer chase) equals the
    # level-serial spec on real mid-search trees of every depth
    tree, teval, cfg = _k1_tree(64, 24, seed=7)
    gen = torch.Generator().manual_seed(7)
    B, T = tree.parents.shape
    for i in range(cfg.n_nodes - 1):
        rands = torch.rand((B, T), generator=gen)
        p_new, a_new = TS.descend(tree, rands)
        p_ref, a_ref = TS.descend_reference(tree, rands)
        assert torch.equal(p_new, p_ref) and torch.equal(a_new, a_ref), i
        TS.simulate(tree, teval, torch.rand((B, T), generator=gen), cfg)
    assert int(tree.parents.amax()) > 2  # the trees grew deeper than the root's children


def _assert_same_tree(a, b, msg=""):
    for name in ("n", "n_edge", "children", "parents"):
        assert torch.equal(getattr(a, name), getattr(b, name)), f"{msg} {name}"
    for name in ("w", "w_edge"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=1e-5,
                                   msg=f"{msg} {name}")


def test_backup_path_matches_backup(monkeypatch):
    # backing up along the recorded path equals re-chasing parent pointers
    # over a whole real search: counts exact, value sums to f32 roundoff
    world = thex.Hex.initial(32, 5, device="cpu")
    _, teval = _models(seed=11)
    cfg = TS.MCTSConfig(n_nodes=24)
    tree_path = TS.mcts(world, teval, Draws(11, "cpu"), cfg)
    monkeypatch.setattr(TS, "backup_path",
                        lambda tree, path, acts, leaves, npv: TS.backup(tree, leaves, npv))
    tree_chase = TS.mcts(world, teval, Draws(11, "cpu"), cfg)
    _assert_same_tree(tree_path, tree_chase)


@pytest.mark.parametrize("backup_kernel", ["ops", "delta", "dense"])
def test_kernel_variants_match_default_route(backup_kernel):
    world = _worlds(5, 16, 5, 3)
    tworld = thex.Hex(board=_t(world.board), seats=_t(world.seats))
    _, teval = _models(seed=3)
    cfg = TS.MCTSConfig(n_nodes=20)
    ref = TS.mcts(tworld, teval, Draws(4, "cpu"), dataclasses.replace(cfg, backup_kernel="ops"))
    var = TS.mcts(tworld, teval, Draws(4, "cpu"),
                  dataclasses.replace(cfg, descend_kernel=True, backup_kernel=backup_kernel))
    _assert_same_tree(ref, var, backup_kernel)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it is on the card; its ops give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _route_backup(descend_kernel, backup_kernel, card):
    """The backup `simulate` calls: the kernels on every tree after
    `descend`, after `walk` on a tree on the card; 'ops' in torch ops."""
    if backup_kernel == "ops":
        return "backup" if descend_kernel else "backup_path"
    if descend_kernel or card:
        return f"kernels.{'backup_dense' if backup_kernel == 'dense' else 'backup'}"
    return "backup_path"


def _launch_checks(tree, leaves, n_per_visit):
    """The checks a backup launch makes on a tree on the card, with every
    tensor of `tree` and `leaves` reporting the card."""
    on_card = {f.name: getattr(tree, f.name).as_subclass(_OnTheCard)
               for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)}
    kernels._check_backup(dataclasses.replace(tree, **on_card), leaves.as_subclass(_OnTheCard),
                          n_per_visit)


@pytest.mark.parametrize("seats", [2, 5])
@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("backup_kernel", ["ops", "delta", "dense"])
@pytest.mark.parametrize("descend_kernel", [False, True])
def test_simulate_calls_the_routes_backup(monkeypatch, descend_kernel, backup_kernel, card,
                                          seats):
    # the route is chosen by the tree's device alone; a kernel refuses a tree
    # on the card with more seats than it takes (4)
    called = []

    def stand_in(label):
        def fn(tree, *args):
            called.append(label)
            if label.startswith("kernels.") and tree.n.is_cuda:
                _launch_checks(tree, *args)
        return fn

    for module, name in ((kernels, "backup"), (kernels, "backup_dense"), (TS, "backup_path"),
                         (TS, "backup")):
        monkeypatch.setattr(module, name,
                            stand_in(f"kernels.{name}" if module is kernels else name))
    world = V.All.initial(4, n_seats=seats, length=2, device="cpu")
    cfg = TS.MCTSConfig(n_nodes=4, descend_kernel=descend_kernel, backup_kernel=backup_kernel)
    tree = TS.initialize(TS.build(world, cfg), V.ProxyAgent()(world), Draws(0, "cpu"), cfg,
                         world.valid)
    if card:
        tree.n = tree.n.as_subclass(_OnTheCard)
    assert tree.n.is_cuda == card and tree.w.shape[-1] == seats
    want = _route_backup(descend_kernel, backup_kernel, card)
    refused = card and seats > 4 and want.startswith("kernels.")
    with (pytest.raises(ValueError, match="at most 4 seats") if refused
          else contextlib.nullcontext()):
        TS.simulate(tree, V.ProxyAgent(), torch.rand(tree.parents.shape), cfg)
    assert called == [want]
