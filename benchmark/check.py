"""The numbers that decide `correct`: what the timed path produced against
what the plain reference works out from the same inputs. Each function
returns plain floats; `judge` holds them to a cell's limits
(`limits/<workload>.json`).
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch


def policy_gap(a, b):
    """Mean over envs of the total-variation distance between two
    log-policies (B,A)."""
    return float(0.5 * (torch.exp(a.float()) - torch.exp(b.float())).abs().sum(-1).mean())


def share_differing(*pairs):
    """Share of envs where any of the (program, reference) tensor pairs
    differ; each tensor's first axis is the env."""
    diff = None
    for a, b in pairs:
        d = (a.reshape(a.shape[0], -1) != b.reshape(b.shape[0], -1)).any(-1)
        diff = d if diff is None else diff | d
    return float(diff.float().mean())


def rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _norms(leaves):
    return {k: float(torch.linalg.vector_norm(x.double())) for k, x in leaves.items()}


def leaf_gap(prog, ref, keep=None):
    """Worst leaf of |norm(prog) - norm(ref)| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keep = list(ref) if keep is None else keep
    p, r = _norms(prog), _norms(ref)
    median = statistics.median(r[k] for k in keep)
    return max(abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keep)


def moved(grad, share=1e-3):
    """Leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under Adam by round-off alone."""
    n = _norms(grad)
    median = statistics.median(n.values())
    return [k for k, v in n.items() if v >= share * median]


def limits(workload):
    return json.loads((Path(__file__).parent / "limits" / f"{workload}.json").read_text())


def judge(numbers, limits):
    """-> (correct, {name: {"value", "limit"}}); a number that is missing or
    not finite fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
