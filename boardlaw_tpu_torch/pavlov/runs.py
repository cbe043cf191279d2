"""Run registry: `ROOT/<'date time suffix'>/_info.json` per run.
Counterpart of boardlaw_tpu/pavlov/runs.py, in the same layout, so either
package reads the other's runs.

A run directory name embeds its creation time plus a readable suffix;
`_info.json` snapshots the description, params and host provenance at
creation. `resolve` accepts exact names, glob fragments, or negative
integers (-1 = latest). Writers across processes take an `fcntl.flock` on
the run's `_lock` file (the JAX package locks the same file with
portalocker) and write with an atomic tmp+rename. Reading runs as a
dataframe (`pandas()`) needs pandas; nothing else here does.
"""
from __future__ import annotations

import fcntl
import json
import os
import socket
import shutil
import tempfile
import time
import uuid
from contextlib import contextmanager
from fnmatch import fnmatch
from pathlib import Path

from . import tests

ROOT = "output/pavlov"

# Short readable suffix words (stand-in for the reference's humanhash names)
_WORDS = (
    "able baker charm delta eager fable grace haste ivory jolly karma lumen "
    "mango noble ocean petal quark ridge sable tulip umber vivid wheat xenon "
    "yucca zesty"
).split()


def root():
    r = Path(os.environ.get("BOARDLAW_RUN_ROOT", ROOT))
    r.mkdir(parents=True, exist_ok=True)
    return r


def run_dir(run):
    return root() / run


def info_path(run):
    return run_dir(run) / "_info.json"


@contextmanager
def lock(run, timeout=30):
    """An exclusive lock on the run, across processes."""
    p = run_dir(run) / "_lock"
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"could not lock run {run!r} in {timeout} s")
                time.sleep(0.01)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def require_pandas():
    """pandas, for the readers that return dataframes; a clear ImportError
    where it is absent (the writers never need it)."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError("pandas is needed to read runs and stats as dataframes; the run "
                          "writers and the numpy readers (npr.Reader) work without it") from e
    return pandas


def _atomic_write_json(path, obj):
    path = Path(path)
    with tempfile.NamedTemporaryFile("w", dir=path.parent, delete=False) as f:
        json.dump(obj, f, indent=2, default=str)
        tmp = f.name
    os.replace(tmp, path)


def new_name(suffix=None):
    now = tests.timestamp()
    suffix = suffix or f"{_WORDS[uuid.uuid4().int % len(_WORDS)]}-{uuid.uuid4().hex[:4]}"
    return f"{now.strftime('%Y-%m-%d %H-%M-%S')} {suffix}"


def new_run(description="", suffix=None, **params):
    """Create a run dir + info record; returns the run name."""
    run = new_name(suffix)
    d = run_dir(run)
    d.mkdir(parents=True, exist_ok=False)
    info = {
        "created": tests.timestamp().isoformat(),
        "description": description,
        "params": params,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "environ": {k: v for k, v in os.environ.items() if not k.startswith("LS_")},
        "_files": {},
    }
    _atomic_write_json(info_path(run), info)
    return run

new = new_run  # reference alias (pavlov.runs.new)


def exists(run):
    return info_path(run).exists()


def info(run):
    with open(info_path(run)) as f:
        return json.load(f)


def update_info(run, fn):
    """Locked read-modify-write of the info record."""
    with lock(run):
        i = info(run)
        fn(i)
        _atomic_write_json(info_path(run), i)
        return i


def list_runs():
    return sorted(p.name for p in root().iterdir() if (p / "_info.json").exists())


def resolve(run):
    """Resolve -1/-2/... (from latest), exact names, or glob prefixes."""
    rs = list_runs()
    if isinstance(run, int):
        return rs[run]
    if run in rs:
        return run
    matches = [r for r in rs if fnmatch(r, f"*{run}*")]
    if len(matches) == 1:
        return matches[0]
    raise ValueError(f"Can't resolve run {run!r}: {len(matches)} matches")


def pandas():
    """All runs as a dataframe (needs pandas)."""
    pd = require_pandas()
    rows = []
    for r in list_runs():
        i = info(r)
        rows.append(
            {
                "run": r,
                "created": i.get("created"),
                "description": i.get("description", ""),
                **{f"params.{k}": v for k, v in i.get("params", {}).items()},
            }
        )
    return pd.DataFrame(rows).set_index("run") if rows else pd.DataFrame()


def delete(run):
    shutil.rmtree(run_dir(run))
