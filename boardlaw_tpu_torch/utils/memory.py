"""Card-memory accounting. Counterpart of boardlaw_tpu/utils/memory.py.

Snapshots of `torch.cuda.memory_stats` with labelled deltas: the bytes the
caching allocator holds for tensors (`allocated_bytes.all.current`) against
the card's total. On the CPU the stats are empty and the usage (0, 0).
"""
from __future__ import annotations

from contextlib import contextmanager
from logging import getLogger

import torch

from . import resolve_device

log = getLogger(__name__)


def stats(device=None):
    """`torch.cuda.memory_stats` of the device (the card by default)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))


def usage(device=None):
    """(bytes allocated to tensors, the card's total bytes)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return 0, 0
    s = stats(device)
    return (s.get("allocated_bytes.all.current", 0),
            torch.cuda.get_device_properties(device).total_memory)


class Monitor:
    """Labelled memory snapshots and their deltas (the reference's per-line
    accumulator, memory.py:18-66, at the granularity of `snap` calls)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.snaps = []

    def snap(self, label):
        self.snaps.append((label, usage(self.device)[0]))

    def rows(self):
        """One dict a snapshot: its label, the bytes in use and the change
        since the snapshot before."""
        out, prev = [], None
        for label, used in self.snaps:
            out.append({"label": label, "bytes_in_use": used,
                        "delta": used - (used if prev is None else prev)})
            prev = used
        return out

    def pandas(self):
        """`rows()` as a DataFrame (needs pandas)."""
        import pandas as pd

        return pd.DataFrame(self.rows(), columns=["label", "bytes_in_use", "delta"])


@contextmanager
def report(label="region", device=None):
    """Log the memory delta of a region."""
    before, _ = usage(device)
    yield
    after, limit = usage(device)
    log.info(f"memory[{label}]: {(after - before) / 2**20:+.1f} MiB "
             f"({after / 2**20:.0f} MiB in use of {limit / 2**20:.0f})")
