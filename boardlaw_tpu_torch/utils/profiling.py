"""Profiling annotations and trace capture. Counterpart of
boardlaw_tpu/utils/profiling.py.

Reference counterpart: rebar/profiling.py, `@nvtx` range decorators gated
on EMIT_NVTX (:15-41) and `profilable` entry points (:43-56). Here: named
ranges gated on BOARDLAW_PROFILE=1 (`torch.cuda.nvtx.range` for
Nsight where the card is, and `torch.profiler.record_function` for
`torch.profiler` traces), and `trace`, a `torch.profiler` capture of the
CPU and the card written as a chrome trace.

    BOARDLAW_PROFILE=1 python train.py            # annotate ranges
    with profiling.trace('/tmp/trace'): step()    # capture a trace
    # open /tmp/trace/trace-*.json in chrome://tracing or Perfetto
"""
from __future__ import annotations

import os
import time
from contextlib import ExitStack, contextmanager
from functools import wraps
from pathlib import Path

import torch


def enabled():
    return os.environ.get("BOARDLAW_PROFILE", "") == "1"


def nvtx(fn):
    """Named-range decorator; a no-op unless BOARDLAW_PROFILE=1 (reference
    profiling.py:15-28)."""

    @wraps(fn)
    def wrapped(*args, **kwargs):
        if not enabled():
            return fn(*args, **kwargs)
        with ExitStack() as stack:
            stack.enter_context(torch.profiler.record_function(fn.__qualname__))
            if torch.cuda.is_available():
                stack.enter_context(torch.cuda.nvtx.range(fn.__qualname__))
            return fn(*args, **kwargs)

    return wrapped


@contextmanager
def trace(logdir):
    """Capture a `torch.profiler` trace of the enclosed region (the card's
    kernels too, where there is one) and write it to
    `logdir/trace-<time>.json`. Yields the profiler; its `path` is set on
    exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.path = logdir / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(str(prof.path))


def profilable(fn):
    """Wrap an entry point so BOARDLAW_PROFILE_DIR captures its trace
    (reference profiling.py:43-56)."""

    @wraps(fn)
    def wrapped(*args, **kwargs):
        logdir = os.environ.get("BOARDLAW_PROFILE_DIR")
        if not logdir:
            return fn(*args, **kwargs)
        with trace(logdir):
            return fn(*args, **kwargs)

    return wrapped
