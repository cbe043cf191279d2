"""Local machine plugin: jobs run as subprocesses on this host.
Counterpart of boardlaw_tpu/fleet/local.py.

A job is its archive unpacked into `workdir/<job>` and its command run there
in a session of its own, with FLEET_NAME, FLEET_PARAMS and FLEET_DEVICES (the
allocated cards, comma-separated) in its environment and its output in
`fleet-out.log`. Liveness needs no psutil: `alive` reaps the job if it is
this process's child and has ended, and counts a pid that is gone or a
zombie as dead (the launching process never waits on its jobs).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tarfile
from pathlib import Path

from . import jobs


def _state(pid):
    """The process's state letter from /proc (R, S, Z, ...); None where
    /proc does not say."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return None


class Machine:
    def __init__(self, spec):
        self.spec = spec
        self.name = spec.name
        self.resources = spec.resources
        self.workdir = Path(spec.config.get("workdir", jobs.root() / "local"))

    def launch(self, job, allocation):
        d = self.workdir / job.name
        d.mkdir(parents=True, exist_ok=True)
        with tarfile.open(job.archive) as tar:
            tar.extractall(d, filter="tar")

        env = dict(os.environ)
        env["FLEET_NAME"] = job.name
        env["FLEET_PARAMS"] = json.dumps(job.params)
        env["FLEET_DEVICES"] = ",".join(str(x) for x in allocation.get("devices", []))

        with open(d / "fleet-out.log", "w") as out:
            p = subprocess.Popen(
                job.command,
                shell=True,
                cwd=d,
                env=env,
                stdout=out,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        return p.pid

    def alive(self, job):
        pid = job.pid
        if pid <= 0:  # never launched; os.kill and os.waitpid would address groups
            return False
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:  # our child, ended and now reaped
                return False
        except ChildProcessError:  # not a child of this process (or reaped already)
            pass
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:  # another user's process: it exists
            return True
        return _state(pid) != "Z"

    def fetch(self, job, target="output"):
        """Copy the job's output dir back."""
        src = self.workdir / job.name / "output"
        if not src.exists():
            return
        dst = Path(target)
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copytree(src, dst, dirs_exist_ok=True)

    def cleanup(self, job):
        d = self.workdir / job.name
        if d.exists():
            shutil.rmtree(d)

    def tail(self, job, n=20):
        p = self.workdir / job.name / "fleet-out.log"
        if not p.exists():
            return ""
        return "".join(p.read_text().splitlines(keepends=True)[-n:])
