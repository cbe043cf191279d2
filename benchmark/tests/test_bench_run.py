"""Runs of every cell at a small size on the CPU, with the port's plain
twins under its kernel wrappers: correct against the reference, the
control (the reference one precision below the configuration's in the
program's place: bfloat16 for float32 on a CPU, TF32 on a card, float8 for
bfloat16) not correct, and a run with the timed path broken underneath not
correct.
A run without a card exits non-zero and prints no result."""
import json
import subprocess
import sys
import time
from dataclasses import replace

import pytest
import torch

from benchmark import check, control, harness, spec
from benchmark.tests.conftest import WORKLOADS, tiny

SEED = 4_000_000_017  # more than 32 signed bits hold


def test_no_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(spec.HERE / "run.py"), "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def run(name, traced=False, cell=None):
    return harness.run(name, SEED, 0.5, traced, time.perf_counter(), device="cpu",
                       cell=cell or tiny(name))


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_runs_correct_on_the_cpu(name, traced):
    result = run(name, traced)
    json.dumps(result)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0
    cell = spec.cell(name)
    want = [m["name"] for m in (cell.per_layer if traced else cell.end_to_end)]
    roofline = [m for m in want if m.endswith("_roofline")]  # no kernel runs on the CPU
    assert set(result["metrics"]) == set(want) - set(roofline)
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_and_the_program_passes(name):
    cell = tiny(name)
    dev = torch.device("cpu")
    if cell.traffic["kind"] == "selfplay":
        out = control.selfplay(cell, SEED, dev)
    else:
        out = control.league(cell, SEED, dev, 1.0)
    limits = check.limits(name)
    assert check.judge(out["program"], limits)[0], out["program"]
    for kind in ("control", "answer", "half"):
        if kind in out:
            assert not check.judge(out[kind], limits)[0], (kind, out[kind])


class _Still(torch.optim.Adam):
    """An optimizer whose step leaves the weights and its state as they are."""

    def step(self, closure=None):
        return None


def _unchanged(monkeypatch):
    from boardlaw_tpu_torch import train

    monkeypatch.setattr(train, "make_optimizer", lambda cfg, params: _Still(params, lr=cfg.lr))


def _half_batch(monkeypatch):
    from boardlaw_tpu_torch import train

    losses = train.losses

    def half(model, batch):
        n = batch["logits"].shape[0] // 2
        cut = {k: v[:n] for k, v in batch.items() if k != "worlds"}
        cut["worlds"] = replace(batch["worlds"], board=batch["worlds"].board[:n],
                                seats=batch["worlds"].seats[:n])
        return losses(model, cut)

    monkeypatch.setattr(train, "losses", half)


def _answer_altered(monkeypatch):
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.mcts import search

    root = search.root

    def rolled(tree):
        r = root(tree)
        return dict(r, logits=r["logits"].roll(1, -1))

    monkeypatch.setattr(train, "mcts_root", rolled)
    monkeypatch.setattr(search, "root", rolled)


def _mix_cut_short(monkeypatch):
    from boardlaw_tpu_torch import learning

    mix = learning.mix
    monkeypatch.setattr(learning, "mix", lambda world, draws, T=2500: mix(world, draws, T - 1))


def _half_the_envs(monkeypatch):
    from boardlaw_tpu_torch.arena import neural

    suggest = neural.Tracker.suggest

    def half(self, seats):
        name, mask = suggest(self, seats)
        mask[len(mask) // 2:] = False
        return name, mask

    monkeypatch.setattr(neural.Tracker, "suggest", half)


FAULTS = {"selfplay": [_unchanged, _half_batch, _answer_altered, _mix_cut_short],
          "league": [_answer_altered, _half_the_envs]}


@pytest.mark.parametrize("fault", [f for fs in FAULTS.values() for f in fs],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    if fault not in FAULTS[cell.traffic["kind"]]:
        pytest.skip(f"{name} has no {fault.__name__.strip('_')} fault")
    fault(monkeypatch)
    assert not run(name, cell=cell)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_tf32_control_fails_on_the_card(name, card):
    """The cell's control on the card (TF32; float8 for a bfloat16
    configuration), at its widths, nodes and buffer on fewer envs and a
    short mix. The buffer stays the cell's: its length sets the share of
    the newest step in the learner's batch, and so how far a search that
    the two sides' rounding split apart moves the weights' change."""
    cell = spec.cell(name)
    if cell.traffic["kind"] == "selfplay":
        cell.config.update(n_envs=2048, mix_steps=20)
        cell.traffic.update(mix_sample=8)
        out = control.selfplay(cell, SEED, card)
    else:
        cell.traffic.update(n_envs=256, check_plies=3)
        out = control.league(cell, SEED, card, 3.0)
    limits = check.limits(name)
    assert check.judge(out["program"], limits)[0], out["program"]
    assert not check.judge(out["control"], limits)[0], out["control"]
