"""The K>1 search's backup route and the `backup_prefix` wrapper, on the
CPU.

* The backup `simulate_multi` calls, by the tree's device alone, at one to
  five seats and both `backup_n`: with `backup_mode='prefix'` the
  `backup_prefix` kernel on the card, whose launch checks refuse more seats
  than it takes, and `backup_paths_prefix` on the CPU; with 'einsum' the
  spec `backup_paths` on either.
* The wrapper's checks refuse a tensor of the wrong storage type or shape,
  a tree without `prew`, more than 4 seats and a fractional count a visit
  before they look at the device, so the refusals are testable here.
* Given CPU tensors the wrapper runs its twin, `backup_paths_prefix`, and
  counts no launch.
"""
import copy
import dataclasses

import pytest
import torch

from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import validation as V
from boardlaw_tpu_torch.mcts import kernels
from boardlaw_tpu_torch.mcts import search as TS
from test_torch_search_k1 import _OnTheCard


def _on_card(x):
    return x.as_subclass(_OnTheCard)


def _prefix_launch_checks(tree, paths, acts, leaves, n_per_visit):
    """The checks a `backup_prefix` launch makes on a tree on the card, with
    every tensor of `tree` and the inputs reporting the card."""
    on_card = {f.name: _on_card(getattr(tree, f.name)) for f in dataclasses.fields(tree)
               if isinstance(getattr(tree, f.name), torch.Tensor)}
    kernels._check_backup_prefix(dataclasses.replace(tree, **on_card), _on_card(paths),
                                 _on_card(acts), _on_card(leaves), n_per_visit)


def _first_pass(seats=2, backup_n="seats", backup_mode="prefix", card=False, n_envs=4):
    """A fresh K=2 grow tree of `All` worlds after its first pass, run by
    `simulate_multi` (whatever backup the caller has planted)."""
    world = V.All.initial(n_envs, n_seats=seats, length=3, device="cpu")
    cfg = TS.MCTSConfig(n_nodes=7, leaves_per_pass=2, grow_passes=True, backup_n=backup_n,
                        backup_mode=backup_mode)
    tree = TS.initialize(TS.build(world, cfg), V.ProxyAgent()(world), Draws(0, "cpu"), cfg,
                         world.valid)
    if card:
        tree.n = _on_card(tree.n)
    assert tree.n.is_cuda == card and tree.w.shape[-1] == seats
    R, L = TS.pass_shape(cfg, 0)
    rands = torch.rand((cfg.leaves_per_pass, n_envs, R),
                       generator=torch.Generator().manual_seed(seats))
    TS.simulate_multi(tree, V.ProxyAgent(), rands, cfg, rows=R, max_levels=L)
    return tree


@pytest.mark.parametrize("backup_mode", ["prefix", "einsum"])
@pytest.mark.parametrize("backup_n", ["seats", "visits"])
@pytest.mark.parametrize("seats", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("card", [False, True])
def test_simulate_multi_calls_the_routes_backup(monkeypatch, card, seats, backup_n,
                                                backup_mode):
    called = []

    def stand_in(label):
        def fn(tree, paths, acts, leaves, n_per_visit):
            called.append((label, n_per_visit))
            if label == "kernels.backup_prefix":
                _prefix_launch_checks(tree, paths, acts, leaves, n_per_visit)
        return fn

    monkeypatch.setattr(kernels, "backup_prefix", stand_in("kernels.backup_prefix"))
    for name in ("backup_paths_prefix", "backup_paths"):
        monkeypatch.setattr(TS, name, stand_in(name))
    refused = card and seats > 4 and backup_mode == "prefix"
    if refused:
        with pytest.raises(ValueError, match="at most 4 seats"):
            _first_pass(seats, backup_n, backup_mode, card)
    else:
        _first_pass(seats, backup_n, backup_mode, card)
    route = ("backup_paths" if backup_mode == "einsum"
             else "kernels.backup_prefix" if card else "backup_paths_prefix")
    assert called == [(route, seats if backup_n == "seats" else 1)]


@pytest.fixture(scope="module")
def pass_inputs():
    """The tree before the backup of a real second pass (K=2, 2 seats) and
    the backup's inputs: paths, acts (the sampler's permuted view), leaves
    and the count a visit."""
    captured = []
    original = TS.backup_paths_prefix

    def capture(tree, paths, acts, leaves, n_per_visit):
        captured.append((copy.deepcopy(tree), paths, acts, leaves, n_per_visit))
        return original(tree, paths, acts, leaves, n_per_visit)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(TS, "backup_paths_prefix", capture)
        world = V.All.initial(4, n_seats=2, length=3, device="cpu")
        cfg = TS.MCTSConfig(n_nodes=7, leaves_per_pass=2, grow_passes=True)
        TS.mcts(world, V.ProxyAgent(), Draws(1, "cpu"), cfg)
    assert len(captured) == cfg.n_passes
    return captured[1]


def _bad_inputs(tree, paths, acts, leaves):
    """(name, tree, paths, acts, leaves) with one input off its storage type
    or shape."""
    def tree_with(**kw):
        return dataclasses.replace(tree, **kw), paths, acts, leaves

    return {
        "paths": (tree, paths.long(), acts, leaves),
        "paths_shape": (tree, paths[:, :1], acts, leaves),
        "leaves": (tree, paths, acts, leaves.long()),
        "leaves_shape": (tree, paths, acts, leaves[:1]),
        "acts": (tree, paths, acts.long(), leaves),
        "acts_shape": (tree, paths, acts[:1], leaves),
        "acts_stride": (tree, paths, acts[:, :, ::2], leaves),
        "v": tree_with(v=tree.v.double()),
        "prew": tree_with(prew=tree.prew[:, :1]),
        "terminal": tree_with(terminal=tree.terminal.to(torch.uint8)),
        "rewards": tree_with(rewards=tree.rewards.double()),
        "seats": tree_with(seats=tree.seats.long()),
        "n": tree_with(n=tree.n.long()),
        "w": tree_with(w=tree.w.double()),
        "n_edge": tree_with(n_edge=tree.n_edge.half()),
        "w_edge": tree_with(w_edge=tree.w_edge[:, :, :1]),
    }


@pytest.mark.parametrize("case", ["paths", "paths_shape", "leaves", "leaves_shape", "acts",
                                  "acts_shape", "acts_stride", "v", "prew", "terminal",
                                  "rewards", "seats", "n", "w", "n_edge", "w_edge"])
def test_backup_prefix_checks_refuse_bad_inputs(pass_inputs, case):
    tree, paths, acts, leaves, npv = pass_inputs
    bad = _bad_inputs(tree, paths, acts, leaves)[case]
    name = case if case in ("n_edge", "w_edge") else case.split("_")[0]
    with pytest.raises(ValueError, match=f"^{name} must be"):
        kernels._check_backup_prefix(*bad, npv)


def test_backup_prefix_checks_before_the_device(pass_inputs):
    tree, paths, acts, leaves, npv = pass_inputs
    with pytest.raises(ValueError, match="needs backup_mode='prefix'"):
        kernels._check_backup_prefix(dataclasses.replace(tree, prew=None), paths, acts,
                                     leaves, npv)
    with pytest.raises(ValueError, match="^n_per_visit must be whole"):
        kernels._check_backup_prefix(tree, paths, acts, leaves, 1.5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # good inputs, on the CPU
        kernels._check_backup_prefix(tree, paths, acts, leaves, npv)
    # five seats: more than the kernel takes
    five = _first_pass(seats=5)
    K, B, L = paths.shape
    five_leaves = torch.zeros((K, B), dtype=torch.int32)
    five_paths = torch.full((K, B, L), -1, dtype=torch.int32)
    five_acts = torch.zeros((K, B, acts.shape[2]), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 4 seats"):
        kernels._check_backup_prefix(five, five_paths, five_acts, five_leaves, 5)


def test_backup_prefix_runs_its_twin_on_the_cpu(pass_inputs):
    tree, paths, acts, leaves, npv = pass_inputs
    n0 = dict(kernels.launches)
    out = kernels.backup_prefix(copy.deepcopy(tree), paths, acts, leaves, npv)
    ref = TS.backup_paths_prefix(copy.deepcopy(tree), paths, acts, leaves, npv)
    assert kernels.launches == n0
    assert int((out.n - tree.n).sum()) == npv * int((paths >= 0).sum() + leaves.numel())
    for name in ("n", "w", "n_edge", "w_edge"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
