"""The port's run tools against the JAX package's on the same runs:
`pavlov.archive` (the source snapshot), `stats.resampled_arrays` (the numpy
resampler, against pandas' `resampled` for every kind), `pavlov.monitoring`
and `pavlov.dashboard` (the same text and the same page, byte for byte, with
pandas and with pandas and matplotlib blocked) and `backup` (a mirror each
way between the packages). Both packages' `mock_dir` point at one run root
(`BOARDLAW_RUN_ROOT`), so each reads the runs the other writes."""
import datetime
import filecmp
import logging
import os
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from boardlaw_tpu import backup as jbackup
from boardlaw_tpu.pavlov import archive as jarchive
from boardlaw_tpu.pavlov import dashboard as jdashboard
from boardlaw_tpu.pavlov import logs as jlogs
from boardlaw_tpu.pavlov import monitoring as jmonitoring
from boardlaw_tpu.pavlov import runs as jruns
from boardlaw_tpu.pavlov import stats as jstats
from boardlaw_tpu.pavlov import tests as jtests
from boardlaw_tpu_torch import backup
from boardlaw_tpu_torch.pavlov import archive, dashboard, files, logs, monitoring, runs, stats
from boardlaw_tpu_torch.pavlov.tests import mock_dir, mock_time, set_time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each kind's fields, as its writer records them
FIELDS = {"last": ["x"], "max": ["x"], "mean": ["total", "count"], "mean_std": ["mu", "sigma"],
          "cumsum": ["total"], "rate": ["count"], "timeaverage": ["x"], "duty": ["duration"],
          "silent": ["a", "b"], "std": ["x"], "period": ["count"], "max_percent": ["x"],
          "mean_percent": ["total", "count"], "quantiles": ["q0", "q1", "q2"], "line": ["x"]}


def _seed_run(package="torch"):
    """tests/test_dashboard.py's run, with a channel of every kind, written
    by one package's writers: writes 61 s apart with a gap of 4 minutes,
    so the 60 s bins include empty ones."""
    st_, lg, rn, tm = ((stats, logs, runs, (mock_time, set_time)) if package == "torch" else
                       (jstats, jlogs, jruns, (jtests.mock_time, jtests.set_time)))
    run = rn.new_run(description=f"seeded by {package}")
    t0 = datetime.datetime(2020, 1, 1, 23, 58, 30)  # across midnight: the bins' origin
    with st_.to_run(run), tm[0](t0):
        for i, gap in enumerate([1, 1, 1, 5, 1, 1]):
            t0 = t0 + datetime.timedelta(seconds=61 * gap)
            tm[1](t0)
            st_.mean("loss.policy", 3.0 - 0.5 * i)
            st_.mean_std("elo.mohex", -2.0 + 0.3 * i, 0.2)
            st_.rate("sample-rate", 1000)
            st_.quantiles("q.values", np.array([0.1, 0.5, 0.9]) * i)
            st_.last("last.x", float(i))
            st_.max("max.x", float(i % 3))
            st_.cumsum("count.samples", 10)
            st_.timeaverage("time.average", 0.5 * i)
            st_.duty("time.duty", 0.1)
            st_.silent("silent.fields", a=float(i), b=2.0)
            st_.std("std.x", float(i))
            st_.std("std.x", float(i) + 1.5)
            st_.period("period.count", 2)
            st_.max_percent("percent.max", 0.1 * i)
            st_.mean_percent("percent.mean", 0.2, 1)
            st_.line("line.x", float(i) ** 2)
    with lg.to_run(run):
        logging.getLogger("demo").info("dashboard log line <&>")
    return run


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A run root holding a run seeded by each package, and the JAX
    package's text and page for each (pandas under its resampler)."""
    root = tmp_path_factory.mktemp("runs")
    with mock_dir(str(root)):
        out = {}
        for package in ("jax", "torch"):
            run = _seed_run(package)
            out[package] = (run, jdashboard.render(run, rule="60s"),
                            jmonitoring.tree_view(run, "60s"))
    return root, out


def test_seeded_run_covers_every_kind(seeded):
    root, out = seeded
    with mock_dir(str(root)):
        run = out["torch"][0]
        assert {stats.kind_of(run, c) for c in stats.channels(run)} == set(FIELDS)
        _, r = stats.resampled_arrays(run, "loss.policy")
        assert np.isnan(r).any()  # the gap leaves empty bins


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_render_and_tree_view_equal_jax(seeded, package):
    root, out = seeded
    run, page, view = out[package]
    with mock_dir(str(root)):
        assert dashboard.render(run, rule="60s") == page
        assert monitoring.tree_view(run, "60s") == view
        assert monitoring.tree_view(run, "1h") == jmonitoring.tree_view(run, "1h")
        assert dashboard.render(run, rule="1h", points=3) == jdashboard.render(run, rule="1h",
                                                                             points=3)
    assert "polygon" in page and "q.values (q1)" in page and "dashboard log line &lt;&amp;&gt;" in page
    assert page.count("<polyline") >= len(FIELDS)


def test_render_and_tree_view_without_pandas(seeded, tmp_path):
    """The port renders the JAX page (rendered with pandas) with pandas and
    matplotlib blocked: the card's machine has neither."""
    root, out = seeded
    run, page, view = out["torch"]
    code = textwrap.dedent("""
        import sys
        for name in ("pandas", "matplotlib", "jax", "boardlaw_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, %r)
        from boardlaw_tpu_torch.pavlov import dashboard, monitoring
        from boardlaw_tpu_torch.pavlov.tests import mock_dir
        with mock_dir(%r):
            with open(%r, "w") as f:
                f.write(dashboard.render(%r, rule="60s"))
            with open(%r, "w") as f:
                f.write(monitoring.tree_view(%r, "60s"))
        print("ok")
    """ % (ROOT, str(root), str(tmp_path / "page.html"), run, str(tmp_path / "view.txt"), run))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "page.html").read_text() == page
    assert (tmp_path / "view.txt").read_text() == view


def test_dashboard_skips_a_malformed_channel_but_not_a_missing_library(seeded, monkeypatch):
    root, out = seeded
    run = out["torch"][0]
    with mock_dir(str(root)):
        real = stats.resampled_arrays

        def malformed(run_, channel, rule="60s"):
            if channel == "loss.policy":
                raise ValueError("a malformed channel")
            return real(run_, channel, rule)

        monkeypatch.setattr(stats, "resampled_arrays", malformed)
        page = dashboard.render(run)
        assert "loss.policy" not in page and "elo.mohex" in page
        assert "<a malformed channel>" in monitoring.tree_view(run)

        def missing(*args, **kwargs):
            raise ImportError("no module named numpy")

        monkeypatch.setattr(stats, "resampled_arrays", missing)
        for read in (dashboard.render, monitoring.tree_view):
            with pytest.raises(ImportError):
                read(run)


def test_jax_dashboard_needs_pandas_to_import():
    """The JAX dashboard reads through pandas (its stats module imports it),
    so without pandas it does not import: it fails loudly, where a copy of
    its `_series_of` over the port's stats, whose `resampled` raises
    ImportError inside the per-channel `except Exception`, would render a
    page without charts."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pandas"] = None
        sys.path.insert(0, %r)
        try:
            import boardlaw_tpu.pavlov.dashboard
        except ImportError:
            print("ok")
    """ % ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.stdout.strip() == "ok", res.stderr


def test_write_and_serve(seeded):
    root, out = seeded
    run, page, _ = out["torch"]
    with mock_dir(str(root)):
        path = dashboard.write(run)
        assert path == files.path(run, "dashboard.html")
        assert open(path).read() == page
        assert files.glob(run, "dashboard.html") == ["dashboard.html"]
        server = dashboard.serve(run)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/",
                                        timeout=10) as r:
                assert r.status == 200
                assert r.read().decode() == page
        finally:
            server.shutdown()
            server.server_close()


def test_write_under_a_relative_run_root(tmp_path, monkeypatch):
    """The default run root is relative (output/pavlov). The port's `write`
    puts the page in the run dir; the JAX `write` joins the run dir to the
    path `files.new_file` already returns and fails."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BOARDLAW_RUN_ROOT", raising=False)
    run = runs.new_run()
    with stats.to_run(run):
        stats.mean("loss.x", 1.0)
    path = dashboard.write(run)
    assert os.path.exists(path) and "loss.x" in open(path).read()
    with pytest.raises(FileNotFoundError):
        jdashboard.write(run)


def test_monitor_and_plot(seeded, capsys):
    root, out = seeded
    run = out["torch"][0]
    with mock_dir(str(root)):
        monitoring.monitor(run, interval=0, iterations=1)
        text = capsys.readouterr().out
        assert monitoring.tree_view(run) in text and "dashboard log line" in text
        fig = monitoring.plot(run, rule="60s")
        assert fig is not None and len(fig.axes) >= len(stats.channels(run))
        assert all(ax.lines for ax in fig.axes[:len(stats.channels(run))])


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_resampled_arrays_equal_resampled(seeded, package):
    """Through the run's files: the port's numpy resampler equals the port's
    and the JAX package's pandas `resampled` on every channel."""
    root, out = seeded
    run = out[package][0]
    with mock_dir(str(root)):
        for c in stats.channels(run):
            for rule in ("60s", "1h", "5min"):
                _same(stats.resampled_arrays(run, c, rule), stats.resampled(run, c, rule))
                _same(stats.resampled_arrays(run, c, rule), jstats.resampled(run, c, rule))


def _same(arrays, want):
    times, got = arrays
    assert np.array_equal(times, ((want.index - pd.Timestamp(0)) // pd.Timedelta(1, "us")))
    if isinstance(got, dict):
        assert list(got) == list(want.columns)
        for c, v in got.items():
            np.testing.assert_array_equal(v, want[c].to_numpy())  # NaN equal to NaN
    else:
        np.testing.assert_array_equal(got, want.to_numpy())


@st.composite
def channel_rows(draw, kind):
    """A channel's rows: up to 40 time-ordered writes over 3 hours from a
    drawn start (so the bins' origin varies), ties and long gaps included,
    any float64 values (NaN and infinities too)."""
    n = draw(st.integers(1, 40))
    start = draw(st.integers(1_500_000_000_000_000, 1_700_000_000_000_000))
    offsets = sorted(draw(st.lists(st.integers(0, 3 * 3600 * 10 ** 6), min_size=n, max_size=n)))
    arr = np.zeros(n, [("_time", "<i8")] + [(c, "<f8") for c in FIELDS[kind]])
    arr["_time"] = start + np.array(offsets, np.int64)
    for c in FIELDS[kind]:
        arr[c] = draw(st.lists(st.floats(width=64), min_size=n, max_size=n))
    return arr


@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_numpy_resampler_equals_pandas(kind):
    """For every kind, at rules 60s and 1h, `resample_rows` equals the kind's
    pandas `resample` on the frame `stats.pandas` builds: the same bins
    (empty ones included) and the same values, NaN and inf where pandas
    gives them."""

    @settings(max_examples=30, deadline=None, derandomize=True, database=None)
    @given(channel_rows(kind))
    def check(arr):
        df = pd.DataFrame(arr)
        df["_time"] = pd.to_datetime(df["_time"], unit="us")
        df = df.set_index("_time")
        for rule in ("60s", "1h"):
            _same(stats.resample_rows(kind, arr, rule), stats.KINDS[kind].resample(df, rule))

    check()


def test_resample_rows_refuses_a_calendar_rule():
    arr = np.zeros(1, [("_time", "<i8"), ("x", "<f8")])
    with pytest.raises(ValueError):
        stats.resample_rows("last", arr, "1D")
    assert stats.rule_us("90s") == stats.rule_us("1min") + 30 * 10 ** 6


def _tree(tmp_path, git):
    d = tmp_path / "code"
    (d / "pkg").mkdir(parents=True)
    (d / "mod.py").write_text("VALUE = 42\n")
    (d / "pkg" / "sub.py").write_text("OTHER = 7\n")
    (d / "notes.txt").write_text("not python\n")
    if git:
        subprocess.run(["git", "init", "-q"], cwd=d, check=True)
        subprocess.run(["git", "add", "mod.py", "notes.txt", "pkg/sub.py"], cwd=d, check=True)
    return d


@pytest.mark.parametrize("git", [False, True], ids=["plain", "git"])
def test_archive_equals_jax(tmp_path, git):
    d = _tree(tmp_path, git)
    with mock_dir(str(tmp_path / "runs")):
        mine, theirs = runs.new_run(), jruns.new_run()
        p = archive.archive(mine, dir=d)
        jarchive.archive(theirs, dir=d)
        assert archive.archive(mine, dir=d) == p  # the registered file again
        assert sorted(archive.listing(mine)) == sorted(jarchive.listing(theirs))
        assert ("notes.txt" in archive.listing(mine)) == git
        for name in archive.listing(mine):
            assert archive.source(mine, name) == jarchive.source(theirs, name)
            assert archive.source(theirs, name) == jarchive.source(mine, name)
        assert archive.source(mine, "mod.py") == "VALUE = 42\n"


def _equal_trees(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors
    for sub in cmp.common_dirs:
        _equal_trees(os.path.join(a, sub), os.path.join(b, sub))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_backup_both_ways(tmp_path, writer):
    """A store written by one package, mirrored by one package's `backup` and
    restored by the other's `fetch`: equal file for file, and the run
    exists for both."""
    store, mirror, restored = tmp_path / "store", tmp_path / "mirror", tmp_path / "restored"
    there, back = (jbackup, backup) if writer == "jax" else (backup, jbackup)
    with mock_dir(str(store)):
        run = _seed_run(writer)
        there.backup(mirror)
    _equal_trees(store, mirror)
    with mock_dir(str(restored)):
        back.fetch(mirror)
        assert runs.exists(run) and jruns.exists(run)
        assert dashboard.render(run) == jdashboard.render(run)
    _equal_trees(store, restored)
    with mock_dir(str(tmp_path / "one")):
        dst = backup.fetch_run(mirror, run)
        assert runs.exists(run)
        _equal_trees(store / run, dst)
