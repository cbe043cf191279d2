"""Per-run source snapshot for reproducibility. Counterpart of
boardlaw_tpu/pavlov/archive.py, writing the same file.

`archive` stores a tarball (`source.tar.gz`) of the source tree in the run
directory once, so any run can be rerun against the exact code that made
it: the files `git ls-files` lists, or every `*.py` file under the directory
where it is not a git checkout (an unpacked `git archive`). `source` reads
one file back out of it, `listing` names them all.
"""
from __future__ import annotations

import subprocess
import tarfile
from pathlib import Path

from . import files, runs

NAME = "source.tar.gz"


def _tracked(dir):
    """git-tracked files if available, else all .py under the dir."""
    try:
        out = subprocess.run(
            ["git", "ls-files"], cwd=dir, capture_output=True, text=True, check=True
        )
        return [f for f in out.stdout.splitlines() if f.strip()]
    except (OSError, subprocess.CalledProcessError):
        return [str(p.relative_to(dir)) for p in Path(dir).rglob("*.py")]


def archive(run, dir="."):
    """Store the source snapshot in the run dir; a second call returns the
    one already registered."""
    run = runs.resolve(run)
    dir = Path(dir)
    if NAME in runs.info(run).get("_files", {}):
        return files.path(run, NAME)
    p = files.new_file(run, NAME)
    with tarfile.open(p, "w:gz") as tar:
        for f in _tracked(dir):
            src = dir / f
            if src.exists() and src.is_file():
                tar.add(src, arcname=f)
    return p


def source(run, path):
    """Read one file out of a run's source snapshot."""
    run = runs.resolve(run)
    with tarfile.open(files.path(run, NAME)) as tar:
        return tar.extractfile(path).read().decode()


def listing(run):
    run = runs.resolve(run)
    with tarfile.open(files.path(run, NAME)) as tar:
        return tar.getnames()
