"""Spans, counters and trace capture: the port's one tracing system.
Counterpart of boardlaw_tpu/utils/profiling.py.

Reference counterpart: rebar/profiling.py, `@nvtx` range decorators gated
on EMIT_NVTX (:15-41). Here tracing is on under BOARDLAW_PROFILE=1 (read
when the module is imported, and again by `from_env`) or after `enable()`;
`enable(False)` turns it off.

* `span(name, **ids)` names a stretch of the program, as a `with` block or
  as a decorator. Off, it is one flag check that returns a shared null
  context. On, it opens a `torch.profiler.record_function(name)` (a
  `user_annotation` event in any `torch.profiler` trace, on the kernels'
  clock), an NVTX range where there is a card (Nsight), and keeps
  `(name, start_ns, end_ns, span_id, parent_id, ids)` on
  `time.perf_counter_ns`'s clock. A span's ids are its own over its
  parent's: the spans inside `train.step` carry its `step`, those inside a
  search pass its `index`.
* `count(name, n=1)` adds to a counter; off, one flag check. The port
  counts every device-to-host wait of its hot paths as `sync.<site>`.
* `spans()`, `totals()` and `counters()` read the store, `reset()` empties
  it; every thread records into it, each with its own open spans. The store keeps the last `CAP` spans and, of every name, the count,
  total and self (less child spans) seconds, so a long run with tracing on
  stays bounded.
* `trace(logdir)` captures a `torch.profiler` trace of the CPU and the
  card as a chrome trace.

Span names are constants of the modules that open them.

    BOARDLAW_PROFILE=1 python train.py            # spans, counters, NVTX
    with profiling.trace('/tmp/trace'): step()    # capture a trace
    # open /tmp/trace/trace-*.json in chrome://tracing or Perfetto
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from functools import wraps
from pathlib import Path

import torch

ENV = "BOARDLAW_PROFILE"
CAP = 1 << 17  # spans the store keeps

_on = False
_nvtx = None  # whether there is a card for NVTX ranges, asked at the first span on
_nulls = {}  # name -> its shared null context
_local = threading.local()  # the open spans of each thread
_lock = threading.Lock()  # the store is shared by every thread
_ids = itertools.count(1)
_records = deque(maxlen=CAP)
_totals = {}  # name -> [count, total ns, self ns]
_counts = {}


def enable(on=True):
    global _on
    _on = bool(on)


def enabled():
    return _on


def from_env():
    """Tracing on or off as BOARDLAW_PROFILE says (1: on)."""
    enable(os.environ.get(ENV, "") == "1")


class _Null:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "start", "child_ns", "_rf")

    def __init__(self, name, ids):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        if up is not None and up.ids:
            self.ids = {**up.ids, **self.ids}
        self.id = next(_ids)
        self.child_ns = 0
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if _card():
            torch.cuda.nvtx.range_push(self.name)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        with _lock:
            tot = _totals.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self.child_ns
            _records.append((self.name, self.start, end, self.id, self.parent, self.ids))
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


def _card():
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _nvtx


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _decorate(name, fn):
    @wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapped


def span(name, **ids):
    """A span named `name` (a module constant) with `ids` (the `with` form's;
    as a decorator, `@span(name)`, it takes none). Nothing unless tracing
    is on when it opens."""
    if not _on:
        null = _nulls.get(name)
        return null if null is not None else _nulls.setdefault(name, _Null(name))
    return _Span(name, ids)


def count(name, n=1):
    """Add `n` to counter `name` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def nvtx(fn):
    """`span(fn.__qualname__)` as a decorator (reference profiling.py:15-28)."""
    return _decorate(fn.__qualname__, fn)


def open_spans():
    """The names of the spans open on this thread, outermost first."""
    return [s.name for s in _stack()]


def spans():
    """The kept spans, oldest first: (name, start_ns, end_ns, span_id,
    parent_id, ids); parent_id 0 at the top of a thread."""
    with _lock:
        return list(_records)


def totals():
    """name -> (count, total seconds, self seconds) of every span closed
    since `reset`, kept or not."""
    with _lock:
        return {k: (n, t * 1e-9, s * 1e-9) for k, (n, t, s) in _totals.items()}


def counters():
    with _lock:
        return dict(_counts)


def reset():
    """Empty the store (spans still open keep their place)."""
    global _records
    with _lock:
        _records = deque(maxlen=CAP)
        _totals.clear()
        _counts.clear()


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


from_env()
