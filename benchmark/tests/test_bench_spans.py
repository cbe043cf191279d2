"""`benchmark/spans.py` on a hand-built chrome trace (nested spans, a launch
from a second thread, idle gaps, events outside every span, a profiler
annotation that is not the program's), the trace's existing readers and
`breakdown` on the same file, and a run of each cell at a small size on the
CPU with the port's tracing on."""
import gzip
import io
import json
import time

import pytest
import torch

from benchmark import spans, spec, trace
from benchmark.tests.conftest import WORKLOADS, tiny

SEED = 4_000_000_017


def _x(cat, name, ts, dur, tid=1, pid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """A 120 us window. Thread 1: train.step [0,100] > train.actor [2,52] >
    search.pass [10,50] > hex.flood [20,30], then train.learner [52,100]
    with the optimizer's own annotation [55,70]. Launches at 25 (flood), 40
    (pass), 60 (learner), 105 (no span), and at 45 from thread 2 (autograd's
    thread: the time puts it in the pass). A fill has no launch."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 120),
        _x("user_annotation", "train.step", 0, 100),
        _x("user_annotation", "train.actor", 2, 50),
        _x("user_annotation", "search.pass", 10, 40),
        _x("user_annotation", "hex.flood", 20, 10),
        _x("user_annotation", "train.learner", 52, 48),
        _x("user_annotation", "Optimizer.step#Adam.step", 55, 15),
        _x("cpu_op", "aten::mm", 40, 5),
        _x("cpu_op", "aten::copy_", 58, 8),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 60, 1, corr=3),
        _x("cuda_driver", "cuLaunchKernel", 45, 1, tid=2, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 1, corr=5),
        _x("kernel", "bitwise_or_kernel", 26, 4, pid=0, tid=7, corr=1),
        _x("kernel", "sm80_xmma_gemm_f32", 41, 3, pid=0, tid=7, corr=2),
        _x("gpu_memcpy", "Memcpy HtoD", 61, 9, pid=0, tid=7, corr=3),
        _x("kernel", "walk_kernel", 46, 4, pid=0, tid=7, corr=4),
        _x("kernel", "where_kernel", 106, 4, pid=0, tid=7, corr=5),
        _x("gpu_memset", "Memset", 111, 1, pid=0, tid=7),
    ]


@pytest.fixture
def path(tmp_path):
    p = tmp_path / "hand.json.gz"
    with gzip.open(p, "wt") as f:
        json.dump({"traceEvents": _events()}, f)
    return p


def _approx(d):
    return {k: pytest.approx(v, abs=1e-12) for k, v in d.items()}


def test_attribution_by_launch_time(path):
    att = spans.Attribution.load(path)
    us = 1e-6
    # the fill without a launch and the launch after train.step: no span
    assert dict(att.self_s) == _approx({"hex.flood": 4 * us, "search.pass": 7 * us,
                                        "train.learner": 9 * us, spans.OUTSIDE: 5 * us})
    assert dict(att.total_s) == _approx({"hex.flood": 4 * us, "search.pass": 11 * us,
                                         "train.actor": 11 * us, "train.step": 20 * us,
                                         "train.learner": 9 * us})
    # gaps [0,26] [30,41] [44,46] in the pass; [50,61] [70,106] in the
    # learner; [110,111] [112,120] in no span
    assert dict(att.idle_s) == _approx({"search.pass": 39 * us, "train.learner": 47 * us,
                                        spans.OUTSIDE: 9 * us})
    assert att.device_s == pytest.approx(25 * us) and att.attributed == pytest.approx(0.8)
    assert sum(att.idle_s.values()) + att.device_s == pytest.approx(att.window_s)
    rows = att.table(per=2)
    assert rows[0] == ("train.learner", pytest.approx(4.5e-3), pytest.approx(4.5e-3),
                       pytest.approx(23.5e-3))


def test_the_trace_readers_and_breakdown_read_the_same_file_as_before(path):
    spans.Attribution.load(path)
    tr = trace.Trace.load(path)
    assert tr.window_s == pytest.approx(120e-6) and tr.busy_s == pytest.approx(25e-6)
    ctx = {"trace": tr, "profiled": 2, "timed": 4, "step_s": 4 * 100e-6}
    read = spec.Cell.reader
    assert read("launches_per_step.train")(ctx) == 2.0
    assert read("gemm_ms.train")(ctx) == pytest.approx(1.5e-3)
    assert read("device_idle.train")(ctx) == pytest.approx(100 * (1 - 12.5e-6 / 100e-6))
    b = tr.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD", pytest.approx(9e-6)]
    assert b["idle_gaps"] == [["(host between ops)", pytest.approx(93e-6)],
                              ["aten::mm", pytest.approx(2e-6)]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_a_cell_with_the_ports_tracing_on_the_cpu(name, tmp_path):
    from boardlaw_tpu_torch.utils import profiling

    cell = tiny(name)
    clock = time.perf_counter()
    out, att, debug = spans.run(cell, SEED, torch.device("cpu"), tmp_path / "t.json.gz",
                                log=io.StringIO())
    assert not profiling.enabled() and debug is None
    assert att.device_s == 0 and att.attributed == 0  # no device on the CPU
    if cell.traffic["kind"] == "selfplay":
        assert set(out) == {"flood_ms.train", "expand_ms.train", "backup_ms.train",
                            "syncs_per_step.train", "mix_s.train"}
        assert out["flood_ms.train"] == out["expand_ms.train"] == out["backup_ms.train"] == 0
        # a flood check or more a Hex step, the aux once a step
        assert out["syncs_per_step.train"] >= 2
        assert 0 < out["mix_s.train"] < time.perf_counter() - clock
    else:
        assert set(out) == {"tracker_ms.league", "syncs_per_ply.league"}
        assert out["tracker_ms.league"] > 0 and out["syncs_per_ply.league"] >= 4
