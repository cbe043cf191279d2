"""The port (`parallel/`, `utils/`, `sql`, `scaling/`, the analysis
modules, `fleet/`, `backup` and the dashboard among it), chip_smoke.py and
scripts/torch_scaling_study.py import with JAX, flax, optax and the JAX
package blocked, and with the packages the card's machine lacks blocked too
(pandas, portalocker, cloudpickle, msgpack, matplotlib, psutil): they
import torch, numpy, scipy and the standard library only, and name no path
inside the JAX package. Without pandas, the dataframe
readers of `pavlov` raise a clear ImportError and the numpy readers still
work, and the evaluation path (a league, the Elo solvers, the live arena's
round) runs on numpy arrays with names."""
import ast
import glob
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "jaxlib", "flax", "optax", "boardlaw_tpu", "pandas", "portalocker",
                   "cloudpickle", "msgpack", "matplotlib", "psutil")
        for k in [k for k in sys.modules if k.split(".")[0] in blocked]:
            del sys.modules[k]
        for name in blocked:
            sys.modules[name] = None
        sys.path.insert(0, %r)
        import pkgutil, importlib
        import boardlaw_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(boardlaw_tpu_torch.__path__, "boardlaw_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        from scripts import torch_scaling_study
        assert "boardlaw_tpu_torch.mcts.kernels" in names
        assert not any(k.split(".")[0] in blocked for k, v in sys.modules.items()
                       if v is not None)
        for name in ("boardlaw_tpu_torch.pavlov", "boardlaw_tpu_torch.storage",
                     "boardlaw_tpu_torch.envs.validation", "boardlaw_tpu_torch.train",
                     "boardlaw_tpu_torch.arena.common", "boardlaw_tpu_torch.arena.neural",
                     "boardlaw_tpu_torch.arena.live", "boardlaw_tpu_torch.arena.perfect",
                     "boardlaw_tpu_torch.activelo.solvers", "boardlaw_tpu_torch.elos",
                     "boardlaw_tpu_torch.mohex", "boardlaw_tpu_torch.gtp_engine",
                     "boardlaw_tpu_torch.pavlov.json_store", "boardlaw_tpu_torch.parallel",
                     "boardlaw_tpu_torch.parallel.mesh", "boardlaw_tpu_torch.parallel.distributed",
                     "boardlaw_tpu_torch.utils.parallel", "boardlaw_tpu_torch.utils.memory",
                     "boardlaw_tpu_torch.utils.profiling", "boardlaw_tpu_torch.utils.recording",
                     "boardlaw_tpu_torch.utils.trees", "boardlaw_tpu_torch.sql",
                     "boardlaw_tpu_torch.noisescales", "boardlaw_tpu_torch.analysis",
                     "boardlaw_tpu_torch.scaling", "boardlaw_tpu_torch.scaling.data",
                     "boardlaw_tpu_torch.scaling.inflation",
                     "boardlaw_tpu_torch.scaling.transitive", "boardlaw_tpu_torch.scaling.paper",
                     "boardlaw_tpu_torch.arena.best", "boardlaw_tpu_torch.arena.mohex_calibration",
                     "boardlaw_tpu_torch.arena.analysis", "boardlaw_tpu_torch.activelo.examples",
                     "boardlaw_tpu_torch.activelo.plot", "boardlaw_tpu_torch.pavlov.archive",
                     "boardlaw_tpu_torch.pavlov.monitoring", "boardlaw_tpu_torch.pavlov.dashboard",
                     "boardlaw_tpu_torch.backup", "boardlaw_tpu_torch.fleet",
                     "boardlaw_tpu_torch.fleet.jobs", "boardlaw_tpu_torch.fleet.machines",
                     "boardlaw_tpu_torch.fleet.local", "boardlaw_tpu_torch.fleet.ssh",
                     "boardlaw_tpu_torch.fleet.manage", "boardlaw_tpu_torch.fleet.sweep",
                     "boardlaw_tpu_torch.fleet.worker"):
            assert name in sys.modules
        print("ok", len(names))
    """ % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# a path component "boardlaw_tpu" inside a string; a "file.py:line" citation
# of a JAX kernel (chip_smoke.py's `replaces`) names no path that is read
JAX_PATH = re.compile(r"(^|[/\\])boardlaw_tpu([/\\]|$)")
CITATION = re.compile(r"boardlaw_tpu/[\w/]+\.py:\d+")


def jax_paths(source):
    """The string literals of a Python source, its docstrings left out (prose
    may name the JAX counterpart), that name a path inside the JAX package."""
    tree = ast.parse(source)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and JAX_PATH.search(node.value)
            and not CITATION.fullmatch(node.value)]


def test_no_jax_in_port_sources():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|boardlaw_tpu)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_workers.py")]
    paths += glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    for dirpath, _, files in os.walk(os.path.join(ROOT, "boardlaw_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as f:
            source = f.read()
        assert not banned.search(source), path
        assert not jax_paths(source), (path, jax_paths(source))
    # the check sees the path the engine's source was once read from, and
    # passes prose and citations
    assert jax_paths('SOURCE = Path(__file__).parent.parent / "boardlaw_tpu" / "cpp"')
    assert jax_paths('open("../boardlaw_tpu/cpp/gtphex.cpp")')
    assert not jax_paths('"""Counterpart of boardlaw_tpu/fleet/jobs.py."""\n'
                         'REPLACES = "boardlaw_tpu/mcts/pallas_kernels.py:530"')


def test_engine_source_is_the_ports_copy():
    """`gtp_engine.SOURCE` lies inside the port, and its bytes equal the JAX
    package's file (the drift check: the binary's cache tag is the source's
    hash, so an equal copy keeps every cached build)."""
    from boardlaw_tpu_torch import gtp_engine

    port = os.path.join(ROOT, "boardlaw_tpu_torch")
    assert os.path.commonpath([str(gtp_engine.SOURCE.resolve()), port]) == port
    with open(os.path.join(ROOT, "boardlaw_tpu", "cpp", "gtphex.cpp"), "rb") as f:
        assert gtp_engine.SOURCE.read_bytes() == f.read()


def test_pandas_readers_raise_clearly_without_pandas(tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["pandas"] = None
        sys.path.insert(0, %r)
        from boardlaw_tpu_torch.pavlov import runs, stats
        from boardlaw_tpu_torch.pavlov.tests import mock_dir
        with mock_dir(%r):
            run = runs.new_run(description="no pandas")
            with stats.to_run(run):
                stats.cumsum("count.samples", 10)
                stats.cumsum("count.samples", 5)
            assert stats.rows(run, "count.samples")["total"].tolist() == [10.0, 5.0]
            for read in (runs.pandas, lambda: stats.pandas(run, "count.samples"),
                         lambda: stats.resampled(run, "count.samples"),
                         lambda: stats.dataframe(run), lambda: stats.review(run)):
                try:
                    read()
                except ImportError as e:
                    assert "pandas is needed" in str(e), e
                else:
                    raise AssertionError("a dataframe reader ran without pandas")
        print("ok")
    """ % (ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_evaluation_runs_without_pandas(tmp_path):
    code = textwrap.dedent("""
        import sys
        for name in ("pandas", "portalocker", "matplotlib", "jax", "boardlaw_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, %r)
        import numpy as np
        from boardlaw_tpu_torch import activelo, elos, train
        from boardlaw_tpu_torch.arena import common, live, neural
        from boardlaw_tpu_torch.pavlov import stats
        from boardlaw_tpu_torch.pavlov.tests import mock_dir
        agents = {n: live._random_agent() for n in "abc"}
        trials = neural.evaluate(3, agents, n_envs_per=2, n_envs=6, device="cpu")
        assert len(trials) == 6
        ws, gs, names = elos.symmetrize(trials)
        assert names == ["a", "b", "c"] and np.isfinite(elos.solve(ws, gs, device="cpu")).all()
        n, w = live.symmetric_counts(trials, names)
        soln = activelo.solve(n, w, names=names, device="cpu")
        assert activelo.suggest(soln)[0] in names
        try:
            trials.frame()
        except ImportError:
            pass
        else:
            raise AssertionError("a DataFrame without pandas")
        with mock_dir(%r):
            run = train.run(3, 4, 1, n_envs=8, nodes=8, mix_steps=16, buffer_len=4,
                            max_steps=1, device="cpu")
            arena = live.RollingArena(run, n_envs=4, ladder={"rollout-1": live._random_agent()},
                                      device="cpu")
            with stats.to_run(run):
                assert np.isfinite(arena.play())
            assert "elo-arena" in stats.channels(run)
        print("ok")
    """ % (ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_results_database_runs_without_pandas(tmp_path):
    """The card's path through the results database without pandas or
    matplotlib: `sql` rows, the study's train/evaluate stages' league,
    `best`, the noise-scale rows and the fit's core; `Rows.frame()` and the
    DataFrame functions raise a clear ImportError."""
    code = textwrap.dedent("""
        import argparse, os, sys
        for name in ("pandas", "matplotlib", "jax", "boardlaw_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, %r)
        os.environ["BOARDLAW_DB"] = os.path.join(%r, "db.sql")
        import numpy as np
        from boardlaw_tpu_torch import noisescales, sql, train
        from boardlaw_tpu_torch.arena import best
        from boardlaw_tpu_torch.pavlov import storage
        from boardlaw_tpu_torch.pavlov.tests import mock_dir
        from boardlaw_tpu_torch.scaling import data
        from scripts import torch_scaling_study as study
        with mock_dir(%r):
            run = train.run(3, 4, 1, desc=study.DESC, n_envs=8, nodes=4, mix_steps=4,
                            buffer_len=4, max_steps=1, device="cpu")
            sd = storage.load_latest(run)
            for i in range(2):
                storage.save_snapshot(run, {"agent": sd["agent"]}, n_samples=8.0 * (i + 1),
                                      n_flops=1e9 * 4 ** i)
            args = argparse.Namespace(boardsize=3, envs_per=2, league_envs=4, test_k=1,
                                      device="cpu")
            assert len(study.evaluate(args)) == 2
            ags = sql.agent_query()
            assert len(ags) == 2 and len(sql.trial_query(3)) == 2
            assert best.top_agent(3, device="cpu") in ags.index
            assert len(best.std_available(3, device="cpu")) == 1
            aid = noisescales.evaluate(run, 0, nodes=4, c_puct=1 / 16, perf=False, n_envs=8,
                                       chunk_len=4, device="cpu")
            assert len(sql.query("select * from noise_scales where agent_id == ?", aid)) == 3
            for read in (ags.frame, data.load, noisescales.load):
                try:
                    read()
                except ImportError as e:
                    assert "pandas is needed" in str(e), e
                else:
                    raise AssertionError("a DataFrame without pandas")
        fit = data.fit_model(argparse.Namespace(train_flops=np.logspace(9, 12, 8),
                                                boardsize=np.full(8, 3.0),
                                                elo=np.linspace(-2, 0, 8)), device="cpu")
        assert sorted(fit) == ["incline", "plateau"]
        print("ok")
    """ % (ROOT, str(tmp_path), str(tmp_path / "runs")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "ok"
