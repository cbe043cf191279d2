"""The port's own spans and counters (`boardlaw_tpu_torch.utils.profiling`)
read beside a profiled window, and the window's device time attributed to
them.

`Attribution(events)`: each device event of the window (`kernel`,
`gpu_memcpy`, `gpu_memset`) goes to the innermost program span open on the
window's thread at the time of its launch, the `cuda_runtime` or
`cuda_driver` event with the same `args.correlation`. The time decides, not
the launching thread: autograd's backward launches from a thread of its own
while the window's thread waits inside `train.learner`. Each idle gap goes
to the innermost span open at its midpoint. A program span is a
`user_annotation` named in lowercase dotted words (`train.step`); the
profiler's own annotations (`Optimizer.step#Adam.step`) and the window are
not.

A run of this module is a `--trace 1` run of a cell with the port's tracing
on, as the benchmark's traced runs do not yet turn it on:

    python3 benchmark/spans.py --workload <name> --seed <n> [--sync-debug]

It sets the cell up with tracing on (so `train.mix` is timed), runs the
traffic's timed steps (plies) with tracing on and the profiler off (counters
and host times), then its profiled steps under the profiler (device times),
prints the table of device and idle time by span on standard error, and as
the last line of standard output the readings below. `--sync-debug` runs the
timed steps again under `torch.cuda.set_sync_debug_mode("warn")` and prints
each line that warned with the spans open there, and the warnings beside the
`sync.*` counters of the same steps.
"""
from __future__ import annotations

import argparse
import gzip
import json
import re
import sys
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import trace  # noqa: E402

PROGRAM_SPAN = re.compile(r"[a-z_]+(\.[a-z_]+)+")
OUTSIDE = "(outside spans)"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNC_WARNING = "called a synchronizing CUDA operation"


def load(path):
    with gzip.open(path, "rt") if str(path).endswith(".gz") else open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _open_at(spans, times):
    """The names of the spans open at each time, outermost first. `spans`
    (start, end, name), properly nested, sorted by (start, -end)."""
    out = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            # what does not hold the next span has closed
            while stack and stack[-1][1] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


class Attribution:
    """Device and idle seconds of a profiled window by program span:
    `self_s` (the innermost span), `total_s` (every span open, each name
    once), `idle_s` (gaps by the innermost span at their midpoint), and
    `attributed` (the share of the window's device seconds that a span
    holds)."""

    def __init__(self, events):
        tr = trace.Trace(events)
        win = next(e for e in events
                   if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation")
        where = (win.get("pid"), win.get("tid"))
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                        for e in events if e.get("cat") == "user_annotation"
                        and (e.get("pid"), e.get("tid")) == where
                        and e["name"] != trace.WINDOW and PROGRAM_SPAN.fullmatch(e["name"])),
                       key=lambda s: (s[0], -s[1]))
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
        device = []
        for e in events:
            if e.get("cat") not in trace.DEVICE_CATS or "ts" not in e:
                continue
            s = max(float(e["ts"]), tr.start)
            d = min(float(e["ts"]) + float(e.get("dur", 0)), tr.end) - s
            if d > 0:
                device.append((launch.get(e.get("args", {}).get("correlation")), d))

        times = [t if t is not None else -1.0 for t, _ in device]
        edges = [tr.start] + [x for iv in tr.busy() for x in iv] + [tr.end]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        opened = _open_at(spans, times + [(s + e) / 2 for s, e in gaps])

        self.self_s, self.total_s, self.idle_s = defaultdict(float), defaultdict(float), \
            defaultdict(float)
        for (_, d), names in zip(device, opened):
            self.self_s[names[-1] if names else OUTSIDE] += d * 1e-6
            for n in set(names):
                self.total_s[n] += d * 1e-6
        for (s, e), names in zip(gaps, opened[len(device):]):
            self.idle_s[names[-1] if names else OUTSIDE] += (e - s) * 1e-6
        self.device_s = sum(d for _, d in device) * 1e-6
        self.attributed = 1 - self.self_s.get(OUTSIDE, 0.0) / self.device_s if device else 0.0
        self.window_s = tr.window_s

    @classmethod
    def load(cls, path):
        return cls(load(path))

    def table(self, per=1):
        """Rows (span, device self ms, device total ms, idle ms), each a
        step (`per` steps), by device self time."""
        names = sorted(set(self.self_s) | set(self.total_s) | set(self.idle_s),
                       key=lambda n: (-self.self_s.get(n, 0.0), n))
        return [(n, self.self_s.get(n, 0.0) * 1e3 / per, self.total_s.get(n, 0.0) * 1e3 / per,
                 self.idle_s.get(n, 0.0) * 1e3 / per) for n in names]


def syncs(counts):
    return sum(v for k, v in counts.items() if k.startswith("sync."))


def readings(kind, att, host, counts, mix_s, timed, profiled):
    """The per-layer numbers this module reads: device ms a profiled step
    under `hex.flood`, in `search.expand` itself and under `search.backup`,
    host syncs a timed step and the mix's seconds (self-play); the tracker's
    own host ms and the syncs a timed ply (league)."""
    if kind == "selfplay":
        return {"flood_ms.train": att.total_s.get("hex.flood", 0.0) * 1e3 / profiled,
                "expand_ms.train": att.self_s.get("search.expand", 0.0) * 1e3 / profiled,
                "backup_ms.train": att.total_s.get("search.backup", 0.0) * 1e3 / profiled,
                "syncs_per_step.train": syncs(counts) / timed,
                "mix_s.train": mix_s}
    return {"tracker_ms.league": host.get("league.tracker", (0, 0.0, 0.0))[2] * 1e3 / timed,
            "syncs_per_ply.league": syncs(counts) / timed}


class _Loop:
    """A cell's set-up and its step (train step or league ply)."""

    def __init__(self, cell, seed, device):
        self.kind = cell.traffic["kind"]
        self.device = device
        if self.kind == "selfplay":
            from boardlaw_tpu_torch import train
            from benchmark.kinds import selfplay

            self.state, self.draws, self.step_fn, _ = selfplay.set_up(cell, seed, device)
            self.host_scalars = train._host_scalars
            self.n, self.k = cell.traffic["timed_steps"], cell.traffic["profiled_steps"]
        else:
            from benchmark.kinds import league

            self.ev, self.plies = league.set_up(cell, seed, device)
            self.play = league.play_ply
            self.n, self.k = cell.traffic["timed_plies"], cell.traffic["profiled_plies"]

    def steps(self, count, sync=True):
        for _ in range(count):
            if self.kind == "selfplay":
                self.state, aux = self.step_fn(self.state, self.draws)
                self.host_scalars(aux)
            else:
                self.play(self.ev, self.plies)
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def sync_warnings(loop, count):
    """`count` steps under `set_sync_debug_mode("warn")`: -> (warnings, the
    sync.* counters of the same steps, Counter of (file:line, open spans)
    of each warning)."""
    from boardlaw_tpu_torch.utils import profiling

    sites = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            spans = " > ".join(profiling.open_spans())
            sites[(f"{filename}:{lineno}", spans)] += 1

    profiling.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.steps(count, sync=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(sites.values()), profiling.counters(), sites


def run(cell, seed, device, path, sync_debug=False, log=sys.stderr):
    """-> the readings, the Attribution, and with `sync_debug` the warnings,
    the counters and the sites of the same steps."""
    from boardlaw_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    try:
        clock = time.perf_counter()
        loop = _Loop(cell, seed, device)
        mix_s = profiling.totals().get("train.mix", (0, 0.0, 0.0))[1]
        print(f"set-up with spans on: {time.perf_counter() - clock:.3f} s", file=log)
        profiling.reset()
        clock = time.perf_counter()
        loop.steps(loop.n)
        print(f"{loop.n} timed steps with spans on: {time.perf_counter() - clock:.3f} s",
              file=log)
        host, counts = profiling.totals(), profiling.counters()
        debug = sync_warnings(loop, loop.n) if sync_debug and device.type == "cuda" else None
        with trace.profiled(path):
            loop.steps(loop.k)
    finally:
        profiling.enable(False)
    att = Attribution.load(path)
    out = readings(loop.kind, att, host, counts, mix_s, loop.n, loop.k)
    print(f"{'span':<18} {'device self ms':>15} {'device total ms':>16} {'idle ms':>9}  "
          f"(a profiled step; {att.attributed:.4%} of {att.device_s:.6f} device s in spans)",
          file=log)
    for n, s, t, i in att.table(loop.k):
        print(f"{n:<18} {s:>15.4f} {t:>16.4f} {i:>9.4f}", file=log)
    for n, (c, t, s) in sorted(host.items(), key=lambda kv: -kv[1][1]):
        print(f"host {n:<18} {c / loop.n:9.1f} a step {t * 1e3 / loop.n:11.4f} ms "
              f"(self {s * 1e3 / loop.n:.4f})", file=log)
    for n, c in sorted(counts.items()):
        print(f"counter {n} {c / loop.n:.2f} a step", file=log)
    return out, att, debug


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sync-debug", action="store_true")
    args = p.parse_args(argv)
    from benchmark import spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    path = trace.TRACES / f"{args.workload}-{args.seed}-spans.json.gz"
    out, att, debug = run(spec.cell(args.workload), args.seed, device, path, args.sync_debug)
    result = {"readings": out, "attributed": att.attributed, "device_s": att.device_s,
              "window_s": att.window_s}
    if debug is not None:
        warned, counts, sites = debug
        for (where, spans), n in sites.most_common():
            print(f"sync warning x{n} at {where} in {spans or '(no span)'}", file=sys.stderr)
        result.update(sync_warnings=warned, sync_counted=syncs(counts),
                      sync_counters=counts)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
