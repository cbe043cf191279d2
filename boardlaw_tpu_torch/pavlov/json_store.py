"""Locked read-modify-write JSON files inside a run dir. Counterpart of
boardlaw_tpu/pavlov/json_store.py, in the same layout, so each package reads
the other's ledgers.

The arena's cumulative game ledger lives in a per-run JSON file. A writer
holds the run's lock (`runs.lock`: an `fcntl.flock` on the run's `_lock`,
the file the JAX package locks with portalocker) and replaces the file with
an atomic tmp+rename.
"""
from __future__ import annotations

import json
import os
import tempfile

from . import runs


def path(run, name):
    return runs.run_dir(runs.resolve(run)) / f"{name}.json"


def read(run, name, default=None):
    p = path(run, name)
    if not p.exists():
        return {} if default is None else default
    with open(p) as f:
        return json.load(f)


def update(run, name, fn, default=None):
    """Locked read-modify-write: fn(obj) mutates and the result is written
    atomically. Returns the object."""
    run = runs.resolve(run)
    with runs.lock(run):
        obj = read(run, name, default)
        fn(obj)
        p = path(run, name)
        with tempfile.NamedTemporaryFile("w", dir=p.parent, delete=False) as f:
            json.dump(obj, f, indent=2)
            tmp = f.name
        os.replace(tmp, p)
        return obj
