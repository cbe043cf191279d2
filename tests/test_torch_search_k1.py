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
  `test_backup_path_matches_backup`, the latter at one to four seats and
  both `backup_n`; and at every simulation of one search, each K=1 kernel's
  CPU twin (`descend`, `backup`, `backup_dense`) against what the search
  does there.
* The backup `simulate` calls, by the tree's device alone, at one to five
  seats and both `backup_n`: the `backup` kernel on the card, which refuses
  more seats than it takes, and `backup_path` on the CPU.
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


def _backup_search(seats):
    """Worlds and an agent for a search of `seats` seats: the 5x5 Hex net at
    two, `V.All`'s planted values otherwise, its games short enough that
    the searches reach its rewarded terminal nodes."""
    if seats == 2:
        return thex.Hex.initial(32, 5, device="cpu"), _models(seed=11)[1]
    length = {1: 3, 3: 2, 4: 1}[seats]
    return V.All.initial(32, n_seats=seats, length=length, device="cpu"), V.ProxyAgent()


# at one seat both `backup_n` count one a visit
@pytest.mark.parametrize("seats,backup_n", [(1, "seats")] + [(s, n) for s in (2, 3, 4)
                                                             for n in ("seats", "visits")])
def test_backup_path_matches_backup(monkeypatch, seats, backup_n):
    # backing up along the recorded path equals re-chasing parent pointers
    # over a whole real search: counts exact, value sums to f32 roundoff
    world, agent = _backup_search(seats)
    cfg = TS.MCTSConfig(n_nodes=24, backup_n=backup_n)
    tree_path = TS.mcts(world, agent, Draws(11, "cpu"), cfg)
    monkeypatch.setattr(TS, "backup_path",
                        lambda tree, path, acts, leaves, npv: TS.backup(tree, leaves, npv))
    tree_chase = TS.mcts(world, agent, Draws(11, "cpu"), cfg)
    assert tree_path.w.shape[-1] == seats
    _assert_same_tree(tree_path, tree_chase)


@pytest.mark.parametrize("twin", ["descend", "backup", "backup_dense"])
def test_k1_kernel_twins_match_the_default_route(monkeypatch, twin):
    # at every simulation of one 5x5 search, the kernel's CPU twin gives what
    # the search does there: `descend` the walk's (parents, actions), each
    # backup on a copy of the tree `backup_path`'s counts exactly and value
    # sums to f32 roundoff
    world = _worlds(5, 16, 5, 3)
    tworld = thex.Hex(board=_t(world.board), seats=_t(world.seats))
    _, teval = _models(seed=3)
    cfg = TS.MCTSConfig(n_nodes=20)
    simulate, walk, backup_path = TS.simulate, TS._walk_any, TS.backup_path
    descended, checked = [], []

    def simulate_twin(tree, eval_fn, rands, cfg):
        descended.append(kernels.descend(tree, rands))
        return simulate(tree, eval_fn, rands, cfg)

    def walk_checked(tree, acts, nxt):
        out = walk(tree, acts, nxt)
        parents, actions = descended.pop()
        assert torch.equal(out[0], parents) and torch.equal(out[1], actions), len(checked)
        checked.append(twin)
        return out

    def backup_checked(tree, path, acts, leaves, npv):
        copy = dataclasses.replace(tree, **{k: getattr(tree, k).clone()
                                            for k in ("n", "w", "n_edge", "w_edge")})
        getattr(kernels, twin)(copy, leaves, npv)
        backup_path(tree, path, acts, leaves, npv)
        _assert_same_tree(tree, copy, f"{twin}, sim {len(checked)}")
        checked.append(twin)
        return tree

    if twin == "descend":
        monkeypatch.setattr(TS, "simulate", simulate_twin)
        monkeypatch.setattr(TS, "_walk_any", walk_checked)
    else:
        monkeypatch.setattr(TS, "backup_path", backup_checked)
    tree = TS.mcts(tworld, teval, Draws(4, "cpu"), cfg)
    assert checked == [twin] * (cfg.n_nodes - 1) and tree.sim == cfg.n_nodes
    assert int(tree.parents.amax()) > 2  # the trees grew deeper than the root's children


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it is on the card; its ops give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _launch_checks(tree, leaves, n_per_visit):
    """The checks a backup launch makes on a tree on the card, with every
    tensor of `tree` and `leaves` reporting the card."""
    on_card = {f.name: getattr(tree, f.name).as_subclass(_OnTheCard)
               for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)}
    kernels._check_backup(dataclasses.replace(tree, **on_card), leaves.as_subclass(_OnTheCard),
                          n_per_visit)


@pytest.mark.parametrize("backup_n", ["seats", "visits"])
@pytest.mark.parametrize("seats", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("card", [False, True])
def test_simulate_calls_the_routes_backup(monkeypatch, card, seats, backup_n):
    # the backup is chosen by the tree's device alone: the `backup` kernel on
    # the card, whose launch checks refuse more than 4 seats, `backup_path`
    # on the CPU; either with `backup_n`'s count a visit
    called = []

    def stand_in(label):
        def fn(tree, *args):
            called.append((label, args[-1]))
            if label == "kernels.backup":
                _launch_checks(tree, *args)
        return fn

    for module, name in ((kernels, "backup"), (kernels, "backup_dense"), (TS, "backup_path"),
                         (TS, "backup")):
        monkeypatch.setattr(module, name,
                            stand_in(f"kernels.{name}" if module is kernels else name))
    world = V.All.initial(4, n_seats=seats, length=2, device="cpu")
    cfg = TS.MCTSConfig(n_nodes=4, backup_n=backup_n)
    tree = TS.initialize(TS.build(world, cfg), V.ProxyAgent()(world), Draws(0, "cpu"), cfg,
                         world.valid)
    if card:
        tree.n = tree.n.as_subclass(_OnTheCard)
    assert tree.n.is_cuda == card and tree.w.shape[-1] == seats
    with (pytest.raises(ValueError, match="at most 4 seats") if card and seats > 4
          else contextlib.nullcontext()):
        TS.simulate(tree, V.ProxyAgent(), torch.rand(tree.parents.shape), cfg)
    assert called == [("kernels.backup" if card else "backup_path",
                       seats if backup_n == "seats" else 1)]
