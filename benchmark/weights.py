"""The network weights a cell runs with, made from the seed on the device in
one draw: every leaf of `reference.net.layout`, weights scaled by
1/sqrt(fan-in), biases by 0.1 and the ReZero scalars by 0.5, so that every
block already takes part in the first forward pass."""
from __future__ import annotations

import math

import torch

from .reference import net

SCALE = {"bias": 0.1, "alpha": 0.5}


def make(cfg, seed, device):
    """-> dict name -> float32 leaf on `device`, the same for the same seed."""
    leaves = net.layout(cfg["boardsize"], cfg["width"], cfg["depth"])
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, kind), x in zip(leaves, flat.split(sizes)):
        scale = SCALE.get(kind) or 1 / math.sqrt(shape[-1])
        out[name] = (x * scale).view(shape)
    return out
