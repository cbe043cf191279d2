"""Job registry: `.fleet/jobs.json` records guarded by a global lock.
Counterpart of boardlaw_tpu/fleet/jobs.py, in the same format, so either
package reads the other's registry.

Each job is a record (name, command, code archive, resources, params, status
fresh/active/dead, machine, allocation, pid). `submit` tars the working
directory and registers the job fresh. Writers take an `fcntl.flock` on
`FLEET_ROOT/_lock` (portalocker, which the JAX package locks it with, takes
the same lock on Linux).
"""
from __future__ import annotations

import fcntl
import json
import os
import tarfile
import time
import uuid
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from pathlib import Path

ROOT = Path(".fleet")


def root():
    r = Path(os.environ.get("FLEET_ROOT", ROOT))
    r.mkdir(parents=True, exist_ok=True)
    return r


@contextmanager
def lock(timeout=30):
    """An exclusive lock on the registry, across processes: `pavlov.runs.lock`'s
    flock, kept here because the fleet imports neither `pavlov` nor torch
    (`worker` sets the job's cards before torch loads)."""
    with open(root() / "_lock", "a") as f:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"could not lock the fleet registry in {timeout} s")
                time.sleep(0.01)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@dataclass
class Job:
    name: str
    command: str
    archive: str
    resources: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    status: str = "fresh"  # fresh | active | dead
    machine: str = ""
    allocation: dict = field(default_factory=dict)
    pid: int = -1


def _path():
    return root() / "jobs.json"


def jobs(status=None):
    p = _path()
    if not p.exists():
        return {}
    raw = json.loads(p.read_text())
    out = {k: Job(**v) for k, v in raw.items()}
    if status:
        out = {k: j for k, j in out.items() if j.status == status}
    return out


def save(js):
    _path().write_text(json.dumps({k: asdict(j) for k, j in js.items()}, indent=2))


def update(name, **kwargs):
    with lock():
        js = jobs()
        for k, v in kwargs.items():
            setattr(js[name], k, v)
        save(js)


def archive_dir(dir="."):
    """Tar the working directory for shipping to a machine. Respects a
    .fleetignore of path components."""
    dir = Path(dir)
    ignores = {".git", ".fleet", "output", "__pycache__", ".pytest_cache"}
    ignore_file = dir / ".fleetignore"
    if ignore_file.exists():
        ignores |= set(ignore_file.read_text().split())

    out = root() / "archives"
    out.mkdir(exist_ok=True)
    path = out / f"{uuid.uuid4().hex[:8]}.tar.gz"

    def filt(info):
        parts = Path(info.name).parts
        if any(p in ignores for p in parts):
            return None
        return info

    with tarfile.open(path, "w:gz") as tar:
        tar.add(dir, arcname=".", filter=filt)
    return str(path)


def submit(command, dir=".", resources=None, params=None, name=None):
    """Register a fresh job with a code archive."""
    name = name or f"job-{uuid.uuid4().hex[:8]}"
    archive = archive_dir(dir)
    with lock():
        js = jobs()
        js[name] = Job(
            name=name,
            command=command,
            archive=archive,
            resources=resources or {},
            params=params or {},
        )
        save(js)
    return name


def delete(name):
    with lock():
        js = jobs()
        j = js.pop(name, None)
        save(js)
    if j and Path(j.archive).exists():
        os.unlink(j.archive)
