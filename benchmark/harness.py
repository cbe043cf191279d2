"""One run of one cell: its traffic's loop (`kinds/<kind>.py`) sets up,
measures and keeps what it produced; the readers give the per-layer
metrics of a traced run; the reference decides `correct`; the result is
the contract's one JSON line."""
from __future__ import annotations

import subprocess
import sys

import torch

from . import check, spec, trace

# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "boardlaw_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device):
    """(name, power limit) of the card, or of the CPU a test runs on."""
    if device.type != "cuda":
        return "cpu", None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={torch.cuda.current_device()}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    return torch.cuda.get_device_name(device), out or None


def run(workload, seed, seconds, traced, t0, device="cuda", cell=None):
    """-> the result dict of one run (the JSON line's object). `cell`
    replaces the workload's own (the tests' small sizes on the CPU)."""
    cell = cell or spec.cell(workload)
    device = torch.device(device)
    path = trace.TRACES / f"{workload}-{seed}.json.gz" if traced else None
    out = cell.kind().run(cell, seed, seconds, path, device, t0)

    name, power = card(device)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"]), "power_limit": power}
    extra = {}
    if traced:
        ctx = out["ctx"]
        tr = ctx["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = tr.breakdown()
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checks = check.judge(out["numbers"], check.limits(workload))
    return {"correct": correct, "attempted": out["attempted"], "failed": 0, "metrics": metrics,
            "device": dev, **extra, "checks": checks}
