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

import pytest
import torch

from benchmark import check, harness, spec
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
    out = cell.kind().control(cell, SEED, torch.device("cpu"), 1.0)
    limits = check.limits(name)
    assert check.judge(out["program"], limits)[0], out["program"]
    for kind in ("control", "answer", "half"):
        if kind in out:
            assert not check.judge(out[kind], limits)[0], (kind, out[kind])


# every fault each cell's loop can have (`kinds/<kind>.py`'s FAULTS)
BROKEN = [(name, fault) for name in WORKLOADS for fault in spec.cell(name).kind().FAULTS]


@pytest.mark.parametrize("name, fault", BROKEN, ids=[f"{n}-{f}" for n, f in BROKEN])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    cell.kind().FAULTS[fault](monkeypatch)
    assert not run(name, cell=cell)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_tf32_control_fails_on_the_card(name, card):
    """The cell's control on the card (TF32; float8 for a bfloat16
    configuration), at its widths and search on fewer envs (its loop's
    `fewer_envs`)."""
    cell = spec.cell(name)
    cell.kind().fewer_envs(cell)
    out = cell.kind().control(cell, SEED, card, 3.0)
    limits = check.limits(name)
    assert check.judge(out["program"], limits)[0], out["program"]
    assert not check.judge(out["control"], limits)[0], out["control"]
