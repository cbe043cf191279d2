"""The port's `utils/` against the JAX package's, on the CPU: the pools
(tests/test_utils.py's executor cases, and `DeviceExecutor`'s card
pinning), the profiling gate and trace, the memory accounting, the video
encoder, and `trees` against `boardlaw_tpu.utils.trees` on the same numpy
arrays (exactly equal: the helpers only move and select values)."""
import json
import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.utils import trees as jtrees
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.utils import memory, parallel, profiling, recording, trees
import torch_workers

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["serial", "thread", "process"])
def test_executors_map_in_order(kind):
    assert parallel.parallel(torch_workers.square, [1, 2, 3], kind=kind, max_workers=2) == [1, 4, 9]


def test_serial_raises():
    def boom(x):
        raise ValueError("nope")

    with pytest.raises(ValueError):
        parallel.parallel(boom, [1], kind="serial")
    with pytest.raises(ValueError, match="unknown executor"):
        parallel.executor("cluster")


def test_device_executor_pins_cards(monkeypatch):
    # CPU workers see no card; card workers take the visible ones
    # round-robin, one each
    assert parallel.parallel(torch_workers.visible_cards, range(2), kind="device",
                             max_workers=2, device="cpu") == ["", ""]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert parallel.visible_cards() == ["3", "5"]
    with parallel.DeviceExecutor(max_workers=2) as ex:
        got = [f.result() for f in [ex.submit(torch_workers.visible_cards, i) for i in range(6)]]
    assert set(got) <= {"3", "5"} and got
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="no card"):
        parallel.DeviceExecutor(max_workers=1)


def test_nvtx_gate(monkeypatch):
    """BOARDLAW_PROFILE=1 turns the ranges on; the function runs either way."""
    calls = []

    @profiling.nvtx
    def fn(x):
        calls.append(x)
        return x + 1

    try:
        monkeypatch.delenv("BOARDLAW_PROFILE", raising=False)
        profiling.from_env()
        profiling.reset()
        assert not profiling.enabled() and fn(1) == 2 and profiling.totals() == {}
        monkeypatch.setenv("BOARDLAW_PROFILE", "1")
        profiling.from_env()
        assert profiling.enabled() and fn(2) == 3
        assert profiling.totals()[fn.__qualname__][0] == 1
        assert calls == [1, 2]
    finally:
        profiling.enable(False)
        profiling.reset()


def test_trace_and_profilable(tmp_path):
    """`trace` writes a chrome trace in which the spans of a traced run
    (`span`, and `nvtx` on a function) appear beside the ops they hold."""
    @profiling.nvtx
    def step(x):
        return torch.mm(x, x)

    profiling.enable()
    try:
        with profiling.trace(tmp_path / "t") as prof:
            with profiling.span("test.step"):
                step(torch.ones(8, 8))
    finally:
        profiling.enable(False)
        profiling.reset()
    events = json.loads(prof.path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert "aten::mm" in names and {"test.step", step.__qualname__} <= set(spans)
    mm = next(e for e in events if e.get("name") == "aten::mm")
    outer = spans["test.step"]
    assert outer["ts"] <= mm["ts"] <= outer["ts"] + outer["dur"]

    with profiling.trace(tmp_path / "off") as prof:
        with profiling.span("test.step"):
            step(torch.ones(8, 8))
    assert not [e for e in json.loads(prof.path.read_text())["traceEvents"]
                if e.get("cat") == "user_annotation"]


def test_memory_stats(caplog):
    assert memory.stats("cpu") == {} and memory.usage("cpu") == (0, 0)
    m = memory.Monitor("cpu")
    m.snap("a")
    m.snap("b")
    assert [r["label"] for r in m.rows()] == ["a", "b"]
    assert [r["delta"] for r in m.rows()] == [0, 0]
    assert list(m.pandas().label) == ["a", "b"]
    with caplog.at_level(logging.INFO, logger=memory.__name__):
        with memory.report("region", "cpu"):
            pass
    assert "memory[region]" in caplog.text
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU reading
        with pytest.raises(RuntimeError):
            memory.stats()


def test_encoder_keeps_frames(tmp_path):
    enc = recording.Encoder(fps=2)
    for i in range(3):
        enc(np.full((5, 7, 3), i, np.uint8))
    assert enc.array().shape == (3, 5, 7, 3)
    out = enc.save(tmp_path / "v.mp4")
    if not recording.ffmpeg_available():
        np.testing.assert_array_equal(np.load(out), enc.array())
    assert out.exists()


def _tree(rng):
    return {"b": rng.normal(size=(4, 3)).astype(np.float32),
            "a": {"x": rng.integers(0, 5, (4, 2, 2)).astype(np.int32),
                  "y": rng.normal(size=(4,)).astype(np.float32)}}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


def _same(ttree, jtree):
    if isinstance(jtree, dict):
        assert set(ttree) == set(jtree)
        for k in jtree:
            _same(ttree[k], jtree[k])
    else:
        np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree))


@pytest.mark.parametrize("helper", ["map_tree", "stack", "concat", "where", "index",
                                    "leading_shape", "flatten_leading", "unflatten_leading"])
def test_trees_match_jax(helper):
    rng = np.random.default_rng(0)
    a, b = _tree(rng), _tree(rng)
    ta, tb = _torch(a), _torch(b)
    ja, jb = [{k: (jnp.asarray(v) if not isinstance(v, dict) else
                   {kk: jnp.asarray(vv) for kk, vv in v.items()}) for k, v in t.items()}
              for t in (a, b)]
    cond = np.array([True, False, False, True])
    calls = {
        "map_tree": (lambda m, x, y: m.map_tree(lambda p, q: p * 2 + q, x, y)),
        "stack": (lambda m, x, y: m.stack([x, y], axis=1)),
        "concat": (lambda m, x, y: m.concat([x, y])),
        "where": (lambda m, x, y: m.where(torch.tensor(cond) if m is trees else jnp.asarray(cond),
                                          x, y)),
        "index": (lambda m, x, y: m.index(x, torch.tensor([3, 1]) if m is trees
                                          else jnp.asarray([3, 1]))),
        "leading_shape": (lambda m, x, y: m.leading_shape(x, 1)),
        "flatten_leading": (lambda m, x, y: m.flatten_leading(m.stack([x, y]), 2)),
        "unflatten_leading": (lambda m, x, y: m.unflatten_leading(x, (2, 2))),
    }
    got, want = calls[helper](trees, ta, tb), calls[helper](jtrees, ja, jb)
    if helper == "leading_shape":
        assert got == tuple(want) == (4,)
    else:
        _same(got, want)


def test_trees_walk_worlds():
    w = thex.Hex.initial(4, 3, device="cpu")
    two = trees.stack([w, w])
    assert isinstance(two, thex.Hex) and two.board.shape == (2,) + tuple(w.board.shape)
    picked = trees.where(torch.tensor([True, False, True, False]), w,
                         trees.map_tree(lambda x: x + 1, w))
    assert torch.equal(picked.seats, torch.tensor([0, 1, 0, 1], dtype=w.seats.dtype))
    assert len(trees.leaves({"w": w, "n": None, "k": 3})) == 2
