"""Process and thread pools with a switchable executor and submit/wait
sugar. Counterpart of boardlaw_tpu/utils/parallel.py.

Reference counterpart: rebar/parallel.py, `SerialExecutor` for debugging
(:15-26), a CUDA-pinning pool (:28-57), the `VariableExecutor` switch
(:61-82) and the `parallel()` wrapper (:85-142). As in the reference,
`DeviceExecutor` pins each worker to one card through
CUDA_VISIBLE_DEVICES, round-robin over the visible cards; with
`device="cpu"` its workers see no card. Every pool spawns its processes:
CUDA does not survive a fork.
"""
from __future__ import annotations

import concurrent.futures
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from logging import getLogger

log = getLogger(__name__)


class SerialExecutor:
    """Runs submissions immediately in-process: the debuggable executor
    (reference parallel.py:15-26)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kwargs):
        f = concurrent.futures.Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except Exception as e:
            f.set_exception(e)
        return f

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def visible_cards():
    """The ids of the cards this process may use: CUDA_VISIBLE_DEVICES's
    entries, or every card CUDA reports."""
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    if ids is not None:
        return [i for i in ids.split(",") if i.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def _pin(cards, counter):
    """A worker's initializer: take the next card, round-robin (none where
    `cards` is empty), before anything in the worker touches CUDA."""
    with counter.get_lock():
        k = counter.value
        counter.value += 1
    os.environ["CUDA_VISIBLE_DEVICES"] = cards[k % len(cards)] if cards else ""


class DeviceExecutor(ProcessPoolExecutor):
    """Process pool whose workers are each pinned to one card, round-robin
    over the visible ones (the reference's CUDAPoolExecutor,
    parallel.py:28-57); with `device="cpu"` the workers see no card."""

    def __init__(self, max_workers=None, device=None, **kwargs):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        cpu = device is not None and str(device) == "cpu"
        cards = [] if cpu else visible_cards()
        if not cpu and not cards:
            raise RuntimeError("no card is visible; pass device='cpu' for CPU workers")
        super().__init__(max_workers=max_workers, mp_context=ctx, initializer=_pin,
                         initargs=(cards, ctx.Value("i", 0)), **kwargs)


def executor(kind="process", max_workers=None, device=None):
    """The switchable executor factory (reference VariableExecutor,
    parallel.py:61-82); `device` is `DeviceExecutor`'s."""
    if kind == "serial":
        return SerialExecutor()
    if kind == "thread":
        return ThreadPoolExecutor(max_workers=max_workers)
    if kind == "process":
        import multiprocessing as mp

        return ProcessPoolExecutor(max_workers=max_workers, mp_context=mp.get_context("spawn"))
    if kind == "device":
        return DeviceExecutor(max_workers=max_workers, device=device)
    raise ValueError(f"unknown executor kind {kind!r}")


def parallel(fn, items, kind="process", max_workers=None, progress=False, device=None,
             timeout=None):
    """Map fn over items with the chosen executor; keeps the order and
    re-raises the first failure (reference parallel.py:85-142). Past
    `timeout` seconds (None: no limit) the pool's workers are ended and
    TimeoutError raised."""
    ex = executor(kind, max_workers, device)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        futures = [ex.submit(fn, item) for item in items]
        out = []
        for i, f in enumerate(futures):
            out.append(f.result(None if deadline is None
                                else max(deadline - time.monotonic(), 0.0)))
            if progress:
                log.info(f"parallel: {i + 1}/{len(futures)}")
    except BaseException:
        # a hung or failed pool: end its workers rather than wait for them
        for p in list((getattr(ex, "_processes", None) or {}).values()):
            p.terminate()
        ex.shutdown(wait=False, cancel_futures=True)
        raise
    ex.shutdown()
    return out
