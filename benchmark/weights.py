"""The network's leaves a cell runs with, its weights and its buffers, made
from the seed on the device in one draw: every leaf of the layout of the
configuration's network (`reference/nets/`), in its order, each made from
its share of the draw as that network's module says (`draw`)."""
from __future__ import annotations

import math

import torch

from .reference import nets


def make(cfg, seed, device):
    """-> dict name -> float32 leaf on `device`, the same for the same seed."""
    net = nets.module(cfg)
    leaves = net.layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, kind), x in zip(leaves, flat.split(sizes)):
        out[name] = net.draw(x, shape, kind).view(shape)
    return out
