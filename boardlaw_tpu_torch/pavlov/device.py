"""Device memory stats channels. Counterpart of
boardlaw_tpu/pavlov/device.py: the same channels and the same throttle,
read from the CUDA caching allocator (`torch.cuda.memory_stats`: bytes
allocated now and at the peak) and the card's total memory
(`torch.cuda.mem_get_info`).
"""
from __future__ import annotations

import time

import torch

from . import stats

_last = {}


def device(throttle=15, dev=None):
    """Write the device's memory channels at most every `throttle` seconds;
    nothing for a device that is not a CUDA card."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    if dev.type != "cuda":
        return
    now = time.monotonic()
    if now - _last.get("device", -float("inf")) < throttle:
        return
    _last["device"] = now

    s = torch.cuda.memory_stats(dev)
    in_use = s.get("allocated_bytes.all.current", 0)
    peak = s.get("allocated_bytes.all.peak", 0)
    limit = torch.cuda.mem_get_info(dev)[1]
    stats.mean("device.memory-in-use", in_use / 2**20)
    if limit:
        stats.mean("device.memory-percent", 100 * in_use / limit)
    if peak:
        stats.max("device.memory-peak", peak / 2**20)


# on the stats namespace too, as in the JAX package
stats.device = device
