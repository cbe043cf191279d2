"""The traced part of a `--trace 1` run: `torch.profiler` over a fixed
number of steps, the trace written under `benchmark/_traces/`, and what the
per-layer readers take from it: the device's activity on the trace's
timeline (kernels, copies, fills), merged into busy intervals, and the
host's operations, which name the idle gaps between them."""
from __future__ import annotations

import gzip
import json
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

TRACES = Path(__file__).resolve().parent / "_traces"
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# cuBLAS's kernels, by name, with cuBLASLt's split-K reductions
GEMM = ("gemm", "gemv", "xmma", "nvjet", "splitkreduce")


@contextmanager
def profiled(path):
    """Profile the block, which the caller ends with a synchronize, as the
    window `WINDOW`; write the trace to `path` (gzip). Yields a dict that
    holds the parsed `Trace` after the block."""
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    out["trace"] = Trace.load(path)


class Trace:
    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW} range")
        self.start = float(win[0]["ts"])
        self.end = self.start + float(win[0]["dur"])
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"], e["cat"])
            for e in events if e.get("cat") in DEVICE_CATS and "ts" in e)
        # the host's operations on the thread that ran the window, nested
        tid = win[0].get("tid")
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                           for e in events if e.get("cat") == "cpu_op" and e.get("tid") == tid)

    @classmethod
    def load(cls, path):
        with gzip.open(path, "rt") if str(path).endswith(".gz") else open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-6

    def kernels(self, match=None):
        """Kernel events (start, end, name) whose name holds one of `match`."""
        return [(s, e, n) for s, e, n, c in self.device if c == "kernel"
                and (match is None or any(m in n.lower() for m in match))]

    def kernel_s(self, match):
        return sum(e - s for s, e, _ in self.kernels(match)) * 1e-6

    def busy(self):
        """Merged intervals of device activity inside the window."""
        merged = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy()) * 1e-6

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time by
        the host operation that was running in the middle of each gap (the
        innermost one)."""
        ops = defaultdict(float)
        for s, e, n, _ in self.device:
            ops[n] += (e - s) * 1e-6
        gaps = defaultdict(float)
        edges = [self.start] + [x for iv in self.busy() for x in iv] + [self.end]
        stack, j = [], 0
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            while j < len(self.host) and self.host[j][0] <= mid:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            gaps[stack[-1][2] if stack else "(host between ops)"] += (e - s) * 1e-6

        def ranked(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
