"""The port's experiment tracking (`boardlaw_tpu_torch.pavlov`): the cases
of tests/test_pavlov.py against the port, and a run directory written by the
JAX package's pavlov (`_info.json`, registered files, npr stats, a flax
msgpack `latest` and snapshot with float32, int32, bool and bfloat16 arrays
and numpy scalars) read by the port's.

The port writes its checkpoints with `torch.save`, the JAX package with
flax's msgpack; the port's loaders read both, the JAX package reads its own
only. The npr stats files are one format: each package reads the other's.
"""
import datetime
import logging

import numpy as np
import pytest
import torch

from boardlaw_tpu_torch.pavlov import files, logs, npr, runs, stats, storage
from boardlaw_tpu_torch.pavlov.tests import mock_dir, mock_time


def test_run_registry():
    with mock_dir(), mock_time():
        run = runs.new_run(description="demo", width=4, depth=2)
        assert runs.exists(run)
        info = runs.info(run)
        assert info["description"] == "demo"
        assert info["params"] == {"width": 4, "depth": 2}

        assert runs.resolve(-1) == run
        df = runs.pandas()
        assert df.loc[run, "params.width"] == 4

        runs.delete(run)
        assert not runs.exists(run)


def test_file_registry():
    with mock_dir(), mock_time():
        run = runs.new_run()
        p0 = files.new_file(run, "thing.{n}.txt")
        p1 = files.new_file(run, "thing.{n}.txt")
        assert p0.name == "thing.0.txt"
        assert p1.name == "thing.1.txt"
        assert files.glob(run, "thing.{n}.txt") == ["thing.0.txt", "thing.1.txt"]
        assert files.seq(run, "thing.{n}.txt") == [(0, "thing.0.txt"), (1, "thing.1.txt")]


def test_lock_excludes_other_processes():
    # the fcntl lock holds against another process (a second flock on its
    # own open file) and is released on exit
    import fcntl

    with mock_dir():
        run = runs.new_run()
        with runs.lock(run):
            with open(runs.run_dir(run) / "_lock", "a") as f:
                with pytest.raises(BlockingIOError):
                    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        with open(runs.run_dir(run) / "_lock", "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(f, fcntl.LOCK_UN)


def test_npr_roundtrip(tmp_path):
    p = tmp_path / "x.npr"
    w = npr.Writer(p)
    for i in range(5):
        w.write({"_time": i, "x": float(i) ** 2})
    # read while the writer is still open, like a live monitor
    arr = npr.Reader(p).read()
    assert len(arr) == 5
    np.testing.assert_allclose(arr["x"], [0, 1, 4, 9, 16])
    w.close()

    w2 = npr.Writer(p)
    w2.write({"_time": 5, "x": 25.0})
    w2.close()
    assert len(npr.Reader(p).read()) == 6


def test_stats_roundtrip():
    with mock_dir():
        run = runs.new_run()
        with stats.to_run(run):
            stats.mean("loss", 4.0)
            stats.mean("loss", 2.0)
            stats.cumsum("count.samples", 10)
            stats.cumsum("count.samples", 5)
            stats.max("grad.max", 1.0)
            stats.max("grad.max", 3.0)
            stats.mean_std("elo", 0.5, 0.1)

        assert set(stats.channels(run)) == {"loss", "count.samples", "grad.max", "elo"}
        assert stats.kind_of(run, "loss") == "mean"

        loss = stats.resampled(run, "loss", "1h").dropna()
        assert loss.iloc[-1] == 3.0  # (4+2)/2

        total = stats.resampled(run, "count.samples", "1h").dropna()
        assert total.iloc[-1] == 15

        gmax = stats.resampled(run, "grad.max", "1h").dropna()
        assert gmax.iloc[-1] == 3.0

        assert "loss" in stats.review(run, "1h")
        # the numpy reader, which needs no pandas
        assert stats.rows(run, "count.samples")["total"].sum() == 15


def test_stats_deferred_and_tensors():
    # tensors, 0-dim and one-element, are written as numbers
    with mock_dir():
        run = runs.new_run()
        with stats.to_run(run):
            with stats.defer():
                stats.mean("a", torch.tensor(1.0))
                stats.mean("a", torch.tensor([3.0]))
            stats.quantiles("q", torch.tensor([0.1, 0.5, 0.9]))
        assert stats.resampled(run, "a", "1h").dropna().iloc[-1] == 2.0
        np.testing.assert_allclose([stats.rows(run, "q")[f"q{i}"][0] for i in range(3)],
                                   [0.1, 0.5, 0.9], rtol=1e-6)


def test_stats_noop_outside_context():
    with mock_dir():
        runs.new_run()
        stats.mean("ignored", 1.0)  # must not raise or write


def test_storage_roundtrip():
    with mock_dir():
        run = runs.new_run()
        w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        tree = {"w": w, "b": torch.zeros(3, dtype=torch.float64), "view": w[:, 1],
                "opt": [torch.tensor(2), {"mu": torch.ones(2)}], "step": 7, "lr": 0.5}

        storage.save_latest(run, tree)
        out = storage.load_latest(run)
        assert torch.equal(out["w"], tree["w"]) and out["b"].dtype == torch.float64
        assert torch.equal(out["view"], w[:, 1]) and out["view"].untyped_storage().nbytes() == 8
        assert out["step"] == 7 and out["lr"] == 0.5 and int(out["opt"][0]) == 2

        storage.save_snapshot(run, tree, samples=100)
        storage.save_snapshot(run, tree, samples=200)
        snaps = storage.snapshots(run)
        assert sorted(snaps) == [0, 1]
        assert storage.snapshot_info(run, 1)["samples"] == 200
        out = storage.load_snapshot(run, 0)
        assert torch.equal(out["b"], tree["b"])

        storage.save_raw(run, "model", {"arch": "fc", "width": 8})
        assert storage.load_raw(run, "model")["width"] == 8


def test_storage_throttle():
    with mock_dir():
        run = runs.new_run()
        assert storage.throttled_latest(run, {"x": torch.ones(1)}, throttle=3600)
        assert not storage.throttled_latest(run, {"x": torch.ones(1)}, throttle=3600)


def test_logs():
    with mock_dir():
        run = runs.new_run()
        with logs.to_run(run):
            logging.getLogger("demo").info("hello from the run")
        assert "hello from the run" in logs.tail(run)


def test_logs_follow():
    with mock_dir():
        run = runs.new_run()
        with logs.to_run(run):
            logging.getLogger("demo").info("line one")
            gen = logs.follow(run, poll=0.01)
            assert "line one" in next(gen)
            logging.getLogger("demo").info("line two")
            assert "line two" in next(gen)


def test_stats_new_kinds_roundtrip():
    with mock_dir():
        run = runs.new_run()
        with stats.to_run(run):
            stats.std("spread", 1.0)
            stats.std("spread", 3.0)
            stats.period("save-period", 1)
            stats.period("save-period", 1)
            stats.max_percent("util.max", 0.5)
            stats.max_percent("util.max", 0.25)
            stats.mean_percent("util.mean", 0.5)
            stats.mean_percent("util.mean", 0.25)
            stats.quantiles("q.loss", np.array([0.1, 0.5, 0.9]))
            stats.quantiles("q.loss", np.array([0.3, 0.7, 1.1]))
            stats.line("raw", 2.0)
            stats.line("raw", 4.0)

        spread = stats.resampled(run, "spread", "1h").dropna()
        np.testing.assert_allclose(spread.iloc[-1], np.std([1.0, 3.0], ddof=1))

        period = stats.resampled(run, "save-period", "1h").dropna()
        assert period.iloc[-1] == 3600 / 2  # 2 events in a 1h window

        assert stats.resampled(run, "util.max", "1h").dropna().iloc[-1] == 0.5
        assert stats.resampled(run, "util.mean", "1h").dropna().iloc[-1] == 0.375

        q = stats.resampled(run, "q.loss", "1h").dropna()
        np.testing.assert_allclose(q.iloc[-1][["q0", "q1", "q2"]], [0.2, 0.6, 1.0])

        assert stats.resampled(run, "raw", "1h").dropna().iloc[-1] == 3.0
        assert stats.KINDS["max_percent"].percent


def test_stats_dataframe():
    with mock_dir():
        run = runs.new_run()
        with stats.to_run(run):
            stats.mean("loss", 4.0)
            stats.mean_std("elo", 0.5, 0.1)
        df = stats.dataframe(run, "1h")
        assert "loss" in df.columns
        assert "elo.mu" in df.columns and "elo.sigma" in df.columns
        assert df["loss"].dropna().iloc[-1] == 4.0


def test_logs_from_run_forwarding():
    # a writer process logs into the run; the from_run thread forwards the
    # lines into our buffer
    import io
    import multiprocessing as mp
    import time as _time

    with mock_dir() as root:
        run = runs.new_run()
        ctx = mp.get_context("spawn")
        p = ctx.Process(target=_log_writer_child, args=(str(root), run))
        buf = io.StringIO()
        with logs.from_run(run, out=buf, poll=0.05):
            p.start()
            p.join(timeout=60)
            deadline = _time.time() + 10
            while "hello from child" not in buf.getvalue() and _time.time() < deadline:
                _time.sleep(0.05)
        assert p.exitcode == 0
        assert "hello from child" in buf.getvalue()


def _log_writer_child(root, run):
    import logging as _logging
    import os

    os.environ["BOARDLAW_RUN_ROOT"] = root
    from boardlaw_tpu_torch.pavlov import logs as _logs

    with _logs.to_run(run):
        _logging.getLogger("child").info("hello from child")


# --------------------------------------------------------------------------
# Runs written by the JAX package
# --------------------------------------------------------------------------

def test_reads_a_run_the_jax_package_wrote():
    import jax.numpy as jnp
    from boardlaw_tpu.pavlov import files as jfiles, runs as jruns
    from boardlaw_tpu.pavlov import stats as jstats, storage as jstorage
    from boardlaw_tpu.pavlov.tests import mock_time as jmock_time

    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(3, 4)).astype(np.float32)
    tree = {
        "agent": {"params": {"params": {"Dense_0": {"kernel": kernel,
                                                    "bias": np.zeros(4, np.float32)}}},
                  "opt": [np.asarray(3, np.int32), np.ones((2, 2), np.float32)],
                  "step": np.asarray(5),
                  "kwargs": {"n_nodes": 64.0, "c_puct": 0.0625}},
        "mask": np.array([[True, False]]),
        "bf16": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16),
        "scalar": np.float32(2.5),
        "n_samples": 96.0,
        "big": 2 ** 40, "neg": -7, "none": None, "name": "x" * 40,
    }
    with mock_dir(), jmock_time(datetime.datetime(2021, 2, 3)):
        run = jruns.new_run(description="from jax", width=4)
        jfiles.new_file(run, "thing.{n}.txt")
        with jstats.to_run(run):
            jstats.mean("loss", 4.0)
            jstats.mean("loss", 2.0)
            jstats.cumsum("count.samples", 10)
        jstorage.save_latest(run, tree)
        jstorage.save_snapshot(run, tree, n_samples=96.0)

        assert runs.resolve(-1) == run and runs.info(run)["params"] == {"width": 4}
        assert runs.info(run)["created"] == "2021-02-03T00:00:00"
        assert files.glob(run, "thing.{n}.txt") == ["thing.0.txt"]
        assert files.new_file(run, "thing.{n}.txt").name == "thing.1.txt"
        assert stats.channels(run) == ["count.samples", "loss"]
        assert stats.kind_of(run, "count.samples") == "cumsum"
        np.testing.assert_array_equal(stats.rows(run, "loss")["total"], [4.0, 2.0])
        assert stats.resampled(run, "loss", "1h").dropna().iloc[-1] == 3.0

        for out in (storage.load_latest(run), storage.load_snapshot(run, 0)):
            agent = out["agent"]
            got = agent["params"]["params"]["Dense_0"]["kernel"]
            assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(kernel))
            assert agent["opt"][0].dtype == torch.int32 and int(agent["opt"][0]) == 3
            assert int(agent["step"]) == 5 and agent["kwargs"]["c_puct"] == 0.0625
            assert out["mask"].dtype == torch.bool and out["mask"].tolist() == [[True, False]]
            assert out["bf16"].dtype == torch.bfloat16
            assert out["bf16"].float().tolist() == np.asarray(tree["bf16"], np.float32).tolist()
            assert out["scalar"] == 2.5 and out["n_samples"] == 96.0
            assert (out["big"], out["neg"], out["none"], out["name"]) == (2 ** 40, -7, None,
                                                                          "x" * 40)
        assert storage.snapshot_info(run, 0)["n_samples"] == 96.0

        # and the JAX package reads the port's stats in turn
        with mock_time(datetime.datetime(2021, 2, 3)), stats.to_run(run):
            stats.mean("loss", torch.tensor(6.0))
        assert jstats.resampled(run, "loss", "1h").dropna().iloc[-1] == 4.0  # (4+2+6)/3


def test_msgpack_reader_refuses_chunked_arrays():
    from flax import serialization

    chunked = serialization._chunk(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="chunked"):
        storage.msgpack_restore(serialization.msgpack_serialize({"a": chunked}))
    with pytest.raises(ValueError, match="trailing"):
        storage.msgpack_restore(serialization.msgpack_serialize({"a": 1}) + b"\x00")
