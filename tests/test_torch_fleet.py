"""The port's fleet (`boardlaw_tpu_torch.fleet`): tests/test_fleet.py's and
tests/test_fleet_ssh.py's cases against localhost (real local subprocesses;
the ssh transport replaced by the same local shims), the registry read by
both packages, the scheduler's decisions against the JAX package's on one
registry, liveness without psutil, and the worker: its card pinning and one
real `train.run` job on the CPU through `sweep.launch_grid`."""
import json
import os
import shutil
import signal
import stat
import subprocess
import sys
import textwrap
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from boardlaw_tpu.fleet import jobs as jjobs
from boardlaw_tpu.fleet import machines as jmachines
from boardlaw_tpu.fleet import manage as jmanage
from boardlaw_tpu_torch.fleet import jobs, machines, manage, sweep, worker
from boardlaw_tpu_torch.pavlov import runs, stats, storage
from boardlaw_tpu_torch.pavlov.tests import mock_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SSH_SHIM = """#!/usr/bin/env python3
import subprocess, sys
# argv: ssh [args...] host cmd  -- the Machine always passes (host, cmd)
host, cmd = sys.argv[-2], sys.argv[-1]
r = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True)
sys.stdout.write(r.stdout)
sys.stderr.write(r.stderr)
sys.exit(r.returncode)
"""

SCP_SHIM = """#!/usr/bin/env python3
import shutil, sys
src, dst = sys.argv[-2], sys.argv[-1]
dst = dst.split(":", 1)[1] if ":" in dst else dst
src = src.split(":", 1)[1] if ":" in src else src
shutil.copy(src, dst)
"""

RSYNC_SHIM = """#!/usr/bin/env python3
import os, shutil, sys
args = [a for a in sys.argv[1:] if not a.startswith("-")]
args = [a for a in args if a not in ("ssh",)]
src, dst = args[-2], args[-1]
src = src.split(":", 1)[1] if ":" in src else src
if os.path.isdir(src):
    shutil.copytree(src, dst, dirs_exist_ok=True)
"""

RESULT_JOB = (
    "import os, json, pathlib\n"
    "pathlib.Path('output').mkdir(exist_ok=True)\n"
    "with open('output/result.json', 'w') as f:\n"
    "    json.dump({'params': os.environ['FLEET_PARAMS'],"
    " 'devices': os.environ['FLEET_DEVICES']}, f)\n"
)


@pytest.fixture
def fleet_root(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEET_ROOT", str(tmp_path / ".fleet"))
    yield tmp_path


@pytest.fixture
def python_on_path(tmp_path, monkeypatch):
    """`python` on PATH is this interpreter: jobs' commands name `python`."""
    bindir = tmp_path / "pybin"
    bindir.mkdir()
    shim = bindir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    yield bindir


@pytest.fixture
def fake_transport(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in [("ssh", SSH_SHIM), ("scp", SCP_SHIM), ("rsync", RSYNC_SHIM)]:
        p = bindir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    yield bindir


def _code(tmp_path, body=RESULT_JOB):
    d = tmp_path / "code"
    d.mkdir(exist_ok=True)
    (d / "job.py").write_text(body)
    return d


def _wait_dead(name, tries=100):
    for _ in range(tries):
        js = manage.refresh()
        if js[name].status == "dead":
            return js
        time.sleep(0.2)
    raise AssertionError(f"{name} never died: {js[name]}")


def _stop(js):
    for j in js.values():
        if j.status == "active" and j.pid > 0:
            try:
                os.killpg(j.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass


def test_job_registry(fleet_root, tmp_path):
    d = tmp_path / "code"
    d.mkdir()
    (d / "hello.py").write_text("print('hi')")
    name = jobs.submit("python hello.py", dir=d, resources={"devices": 1}, params={"x": 1})
    js = jobs.jobs()
    assert js[name].status == "fresh"
    assert js[name].params == {"x": 1}
    assert Path(js[name].archive).exists()
    jobs.update(name, machine="box")
    assert jobs.jobs()[name].machine == "box"
    jobs.delete(name)
    assert name not in jobs.jobs()


def test_local_end_to_end(fleet_root, tmp_path, python_on_path):
    d = _code(tmp_path)
    machines.add("box", "local", resources={"devices": 2}, workdir=str(tmp_path / "work"))
    name = jobs.submit("python job.py", dir=d, resources={"devices": 1}, params={"width": 8})

    js = manage.refresh()
    assert js[name].status == "active"
    assert js[name].allocation["devices"] == [0]
    _wait_dead(name)

    target = tmp_path / "fetched"
    manage.fetch(target=str(target))
    result = json.loads((target / "result.json").read_text())
    assert json.loads(result["params"]) == {"width": 8}
    assert result["devices"] == "0"
    assert manage.tails() == {name: ""}  # the job printed nothing

    manage.cleanup()
    assert name not in jobs.jobs()
    assert not (tmp_path / "work" / name).exists()


def test_allocation_limits(fleet_root, tmp_path, python_on_path):
    d = _code(tmp_path, "import time; time.sleep(30)")
    machines.add("tiny", "local", resources={"devices": 1}, workdir=str(tmp_path / "work"))
    jobs.submit("python job.py", dir=d, resources={"devices": 1})
    jobs.submit("python job.py", dir=d, resources={"devices": 1})
    js = manage.refresh()
    try:
        assert sorted(j.status for j in js.values()) == ["active", "fresh"]
    finally:
        _stop(js)


def test_forbid(fleet_root, tmp_path):
    machines.add("box2", "local", resources={"devices": 1}, workdir=str(tmp_path / "work"))
    machines.forbid("box2")
    assert machines.machines() == {}
    machines.forbid("box2", False)
    assert list(machines.machines()) == ["box2"]


def test_ssh_machine_end_to_end(fleet_root, fake_transport, python_on_path, tmp_path):
    d = _code(tmp_path)
    workdir = tmp_path / "remote-work"
    workdir.mkdir()
    machines.add("farbox", "ssh", resources={"devices": 1}, host="testhost",
                 workdir=str(workdir))
    name = jobs.submit("python job.py", dir=d, resources={"devices": 1}, params={"depth": 2})

    js = manage.refresh()
    assert js[name].status == "active"
    assert js[name].machine == "farbox"
    assert js[name].pid > 0
    _wait_dead(name)

    target = tmp_path / "fetched"
    manage.fetch(target=str(target))
    result = json.loads((target / "result.json").read_text())
    assert json.loads(result["params"]) == {"depth": 2}
    assert result["devices"] == "0"

    assert manage.tails() == {name: ""}
    manage.cleanup()
    assert name not in jobs.jobs()
    assert not (workdir / name).exists()


def test_registries_are_read_by_both_packages(tmp_path, monkeypatch):
    d = _code(tmp_path)
    for writer, reader in (((jobs, machines), (jjobs, jmachines)),
                           ((jjobs, jmachines), (jobs, machines))):
        monkeypatch.setenv("FLEET_ROOT", str(tmp_path / f"{writer[0].__name__}"))
        name = writer[0].submit("python job.py", dir=d, resources={"devices": 2},
                                params={"width": 8, "desc": "x/9"})
        writer[0].update(name, status="active", machine="box", allocation={"devices": [0, 1]},
                         pid=123)
        writer[1].add("box", "local", resources={"devices": [0, 1]}, workdir="w")
        writer[1].add("far", "ssh", resources={"devices": 4}, host="h", ssh_args=["-p", "22"])
        writer[1].forbid("far")
        assert ({k: asdict(v) for k, v in reader[0].jobs().items()}
                == {k: asdict(v) for k, v in writer[0].jobs().items()})
        assert ({k: asdict(v) for k, v in reader[1].specs().items()}
                == {k: asdict(v) for k, v in writer[1].specs().items()})
        assert list(reader[1].machines()) == ["box"]


def _ended_pid():
    p = subprocess.Popen(["true"])
    p.wait()
    return p.pid


@pytest.mark.parametrize("forbidden", [None, "a"])
def test_same_decisions_as_jax(tmp_path, monkeypatch, forbidden):
    """One registry (an active job whose process has ended, one on a machine
    that is gone, then fresh jobs needing 1, 2, 1 and 1 cards; machines of 2
    cards and of the list [1], `a` forbidden in the second case), a copy for
    each package, one `refresh` each: the same status, machine and
    allocation for every job."""
    d = _code(tmp_path)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("FLEET_ROOT", str(mine))
    machines.add("a", "local", resources={"devices": 2})
    machines.add("b", "local", resources={"devices": [1]})
    if forbidden:
        machines.forbid(forbidden)
    jobs.submit("true", dir=d, name="ended")
    jobs.update("ended", status="active", machine="a", allocation={"devices": [0]},
                pid=_ended_pid())
    jobs.submit("true", dir=d, name="orphan")
    jobs.update("orphan", status="active", machine="gone", allocation={"devices": [0]},
                pid=os.getpid())
    for i, need in enumerate([1, 2, 1, 1]):
        jobs.submit("true", dir=d, resources={"devices": need}, name=f"j{i}")
    shutil.copytree(mine, theirs)

    got = manage.refresh()
    monkeypatch.setenv("FLEET_ROOT", str(theirs))
    want = jmanage.refresh()
    decisions = {n: (j.status, j.machine, j.allocation) for n, j in got.items()}
    assert decisions == {n: (j.status, j.machine, j.allocation) for n, j in want.items()}
    expected = ({"j0": ("active", "a", {"devices": [0]}), "j1": ("fresh", "", {}),
                 "j2": ("active", "a", {"devices": [1]}), "j3": ("active", "b", {"devices": [1]})}
                if forbidden is None else
                {"j0": ("active", "b", {"devices": [1]}), "j1": ("fresh", "", {}),
                 "j2": ("fresh", "", {}), "j3": ("fresh", "", {})})
    assert {n: decisions[n] for n in expected} == expected
    assert decisions["ended"][0] == decisions["orphan"][0] == "dead"


def test_liveness_without_psutil(tmp_path):
    """With psutil blocked, a job that exits is marked dead within 10 s and a
    sleeping one stays active; the sleeping one is killed after."""
    code = textwrap.dedent("""
        import os, signal, sys, time
        for name in ("psutil", "jax", "boardlaw_tpu", "torch"):
            sys.modules[name] = None
        sys.path.insert(0, %r)
        os.environ["FLEET_ROOT"] = %r
        from boardlaw_tpu_torch.fleet import jobs, machines, manage
        os.makedirs(%r, exist_ok=True)
        machines.add("box", "local", resources={"devices": 2}, workdir=%r)
        quick = jobs.submit("true", dir=%r)
        slow = jobs.submit("sleep 60", dir=%r)
        js = manage.refresh()
        try:
            assert js[quick].status == js[slow].status == "active"
            deadline = time.monotonic() + 10
            while js[quick].status != "dead" and time.monotonic() < deadline:
                time.sleep(0.2)
                js = manage.refresh()
            assert js[quick].status == "dead", js[quick]
            assert js[slow].status == "active", js[slow]
            assert "psutil" not in [k for k, v in sys.modules.items() if v is not None]
        finally:
            os.killpg(js[slow].pid, signal.SIGTERM)
        deadline = time.monotonic() + 10
        while manage.refresh()[slow].status != "dead" and time.monotonic() < deadline:
            time.sleep(0.2)
        assert manage.refresh()[slow].status == "dead"
        print("ok")
    """ % (ROOT, str(tmp_path / ".fleet"), str(tmp_path / "code"), str(tmp_path / "work"),
           str(tmp_path / "code"), str(tmp_path / "code")))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_zombie_and_missing_pids_are_dead(fleet_root, tmp_path):
    from boardlaw_tpu_torch.fleet import local

    machines.add("box", "local", resources={"devices": 1})
    box = machines.machines()["box"]
    job = jobs.Job(name="x", command="", archive="", pid=-1)
    assert not box.alive(job)
    p = subprocess.Popen(["sleep", "0"])
    deadline = time.monotonic() + 10
    while local._state(p.pid) != "Z" and time.monotonic() < deadline:
        time.sleep(0.05)
    assert local._state(p.pid) == "Z"  # ended, not yet reaped
    job.pid = p.pid
    assert not box.alive(job)  # reaped by `alive`
    assert local._state(p.pid) is None
    job.pid = os.getpid()
    assert box.alive(job)


def test_worker_pins_the_jobs_cards():
    env = {"FLEET_DEVICES": "1"}
    assert worker.pin_devices(env) == "1" and env["CUDA_VISIBLE_DEVICES"] == "1"
    # the allocation indexes the cards the scheduler inherited, never others
    env = {"FLEET_DEVICES": "0", "CUDA_VISIBLE_DEVICES": "3"}
    assert worker.pin_devices(env) == "3"
    env = {"FLEET_DEVICES": "1,0", "CUDA_VISIBLE_DEVICES": "3, 5"}
    assert worker.pin_devices(env) == "5,3"
    env = {"FLEET_DEVICES": "0", "CUDA_VISIBLE_DEVICES": "GPU-1a2b"}
    assert worker.pin_devices(env) == "GPU-1a2b"
    for inherited in ("3", ""):
        env = {"FLEET_DEVICES": "0,1", "CUDA_VISIBLE_DEVICES": inherited}
        with pytest.raises(ValueError):
            worker.pin_devices(env)
        assert env["CUDA_VISIBLE_DEVICES"] == inherited
    env = {"FLEET_DEVICES": "", "CUDA_VISIBLE_DEVICES": "2"}
    assert worker.pin_devices(env) == "2"  # an empty allocation hides no card
    env = {}
    assert worker.pin_devices(env) is None and env == {}


def test_fleet_imports_no_torch():
    """The worker sets CUDA_VISIBLE_DEVICES before torch loads, so the fleet's
    modules, which `python -m boardlaw_tpu_torch.fleet.worker` imports first,
    import none of it."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import boardlaw_tpu_torch.fleet, boardlaw_tpu_torch.fleet.worker\n"
            "import boardlaw_tpu_torch.fleet.ssh\n"
            "print('torch' in sys.modules)") % ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert res.stdout.strip() == "False", res.stderr


def test_sweep_runs_a_worker_job(fleet_root, tmp_path, monkeypatch, python_on_path):
    """`launch_grid` submits one `python -m boardlaw_tpu_torch.fleet.worker` job
    (3x3, width 8, depth 1, on the CPU); the scheduler runs it to its end on a
    local machine; the run fetched back has one learner step; a second
    `launch_grid` of the same grid adds nothing."""
    code = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "boardlaw_tpu_torch"), code / "boardlaw_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    monkeypatch.chdir(code)
    monkeypatch.delenv("BOARDLAW_RUN_ROOT", raising=False)  # the job writes in its own dir
    machines.add("box", "local", resources={"devices": 1}, workdir=str(tmp_path / "work"))
    grid = dict(desc="cpu", n_envs=256, nodes=8, mix_steps=16, buffer_len=4, max_steps=1,
                device="cpu")
    names = sweep.launch_grid(3, [8], [1], **grid)
    assert len(names) == 1
    deadline = time.monotonic() + 60
    js = manage.refresh()
    try:
        while js[names[0]].status != "dead" and time.monotonic() < deadline:
            time.sleep(0.5)
            js = manage.refresh()
    finally:
        _stop(js)
    log = manage.tails(n=1000)[names[0]]
    assert js[names[0]].status == "dead", log
    assert "Traceback" not in log and "fleet worker: training on cpu" in log
    launches = json.loads(log.strip().splitlines()[-1])["kernels.launches"]
    assert "walk" in launches and not any(launches.values())  # the CPU runs the twins

    target = tmp_path / "fetched"
    manage.fetch(target=str(target))
    with mock_dir(str(target / "pavlov")):
        (run,) = runs.list_runs()
        assert runs.info(run)["description"] == "cpu/3"
        assert len(stats.rows(run, "time.step")) == 1
        assert storage.load_latest(run)["agent"]["step"] == 1
        assert np.isfinite(stats.rows(run, "loss.total")["total"]).all()

    assert sweep.launch_grid(3, [8], [1], **grid) == []
    assert [p["width"] for p in sweep.acknowledged("cpu")] == [8]
