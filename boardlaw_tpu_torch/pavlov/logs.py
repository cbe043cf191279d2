"""Per-run log files: a root-logger file handler plus tail readers.
Counterpart of boardlaw_tpu/pavlov/logs.py.

Every process in a run logs to its own `logs.{n}.txt`; readers aggregate
and tail them.
"""
from __future__ import annotations

import logging
from contextlib import contextmanager

from . import files, runs

FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


@contextmanager
def to_run(run):
    run = runs.resolve(run)
    path = files.new_file(run, "logs.{n}.txt")
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(FORMAT))
    root = logging.getLogger()
    old_level = root.level
    root.addHandler(handler)
    if root.level > logging.INFO:
        root.setLevel(logging.INFO)
    try:
        yield
    finally:
        root.removeHandler(handler)
        root.setLevel(old_level)
        handler.close()


def paths(run):
    run = runs.resolve(run)
    return [files.path(run, f) for f in files.glob(run, "logs.{n}.txt")]


def tail(run, n=20):
    """Last n lines across this run's log files."""
    lines = []
    for p in paths(run):
        if p.exists():
            with open(p) as f:
                lines.extend(f.readlines())
    return "".join(lines[-n:])


def follow(run, poll=1.0):
    """Generator yielding new log lines as any of the run's processes write
    them — the reference's multi-process live tailer (logs.py:84-148) as a
    pull-based iterator (use `for line in logs.follow(run): ...`)."""
    import time

    offsets = {}
    while True:
        emitted = False
        for p in paths(run):
            if not p.exists():
                continue
            with open(p) as f:
                f.seek(offsets.get(p, 0))
                for line in f:
                    emitted = True
                    yield line
                offsets[p] = f.tell()
        if not emitted:
            time.sleep(poll)


@contextmanager
def from_run(run, out=None, poll=0.5):
    """Background-thread forwarder: tails every process's log file of `run`
    and re-prints new lines while the context is open. A KeyboardInterrupt in
    the reader thread is propagated to the main thread, so ctrl-C'ing a
    monitor stops the run it watches (reference logs.py:150-193)."""
    import _thread
    import sys
    import threading
    import time as _time

    run = runs.resolve(run)
    out = out or sys.stdout
    stop = threading.Event()

    def _pump():
        offsets = {}
        try:
            while not stop.is_set():
                for p in paths(run):
                    if not p.exists():
                        continue
                    with open(p) as f:
                        f.seek(offsets.get(p, 0))
                        for line in f:
                            out.write(line)
                        offsets[p] = f.tell()
                _time.sleep(poll)
        except KeyboardInterrupt:
            _thread.interrupt_main()

    t = threading.Thread(target=_pump, daemon=True, name=f"logs-from-{run}")
    t.start()
    try:
        yield t
    finally:
        stop.set()
        t.join(timeout=2 * poll + 1)
