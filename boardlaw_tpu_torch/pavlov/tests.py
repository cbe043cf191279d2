"""Test doubles: a settable frozen clock and a throwaway run root.
Counterpart of boardlaw_tpu/pavlov/tests.py.

Every pavlov writer reads the time from `timestamp()`, which `mock_time`
freezes; `mock_dir` points the run root (`BOARDLAW_RUN_ROOT`) at a scratch
directory.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from contextlib import contextmanager

_FROZEN = None


def timestamp():
    """The single clock used by every pavlov writer."""
    if _FROZEN is not None:
        return _FROZEN
    return datetime.datetime.now()


def set_time(t):
    global _FROZEN
    _FROZEN = t


@contextmanager
def mock_time(t=None):
    global _FROZEN
    old = _FROZEN
    _FROZEN = t or datetime.datetime(2020, 1, 1)
    try:
        yield
    finally:
        _FROZEN = old


@contextmanager
def mock_dir(path=None):
    old = os.environ.get("BOARDLAW_RUN_ROOT")
    tmp = path or tempfile.mkdtemp(prefix="pavlov-test-")
    os.environ["BOARDLAW_RUN_ROOT"] = str(tmp)
    try:
        yield tmp
    finally:
        if old is None:
            os.environ.pop("BOARDLAW_RUN_ROOT", None)
        else:
            os.environ["BOARDLAW_RUN_ROOT"] = old
