"""Per-run file registry inside `_info.json._files`. Counterpart of
boardlaw_tpu/pavlov/files.py.

Every file created in a run dir is registered with its pattern, creation
time and process provenance; `{n}` patterns are sequence families whose next
index is assigned under the run lock.
"""
from __future__ import annotations

import os
import re
import threading
from fnmatch import fnmatch

from . import runs, tests


def _record():
    return {
        "created": tests.timestamp().isoformat(),
        "pid": os.getpid(),
        "thread": threading.current_thread().name,
    }


def new_file(run, pattern, **kwargs):
    """Register (and name) a new file from a pattern; `{n}` patterns get the
    next free sequence index. Returns the full path."""
    run = runs.resolve(run)

    state = {}

    def add(info):
        files = info.setdefault("_files", {})
        if "{n}" in pattern:
            regex = re.escape(pattern).replace(r"\{n\}", r"(\d+)")
            ns = [int(m.group(1)) for f in files if (m := re.fullmatch(regex, f))]
            name = pattern.format(n=max(ns) + 1 if ns else 0)
        else:
            name = pattern
        files[name] = {"_pattern": pattern, **_record(), **kwargs}
        state["name"] = name

    runs.update_info(run, add)
    return runs.run_dir(run) / state["name"]


def path(run, name):
    return runs.run_dir(runs.resolve(run)) / name


def glob(run, pattern):
    """Registered filenames matching a glob-ish pattern ({n} -> *)."""
    run = runs.resolve(run)
    files = runs.info(run).get("_files", {})
    pat = pattern.replace("{n}", "*")
    return sorted(f for f in files if fnmatch(f, pat))


def seq(run, pattern):
    """(index, name) pairs for a `{n}` pattern family, ordered by index."""
    run = runs.resolve(run)
    regex = re.escape(pattern).replace(r"\{n\}", r"(\d+)")
    out = []
    for f in runs.info(run).get("_files", {}):
        m = re.fullmatch(regex, f)
        if m:
            out.append((int(m.group(1)), f))
    return sorted(out)


def info(run, name):
    return runs.info(runs.resolve(run))["_files"][name]
