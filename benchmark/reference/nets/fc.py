"""The paper's network, the port's `FCModel`: a dense intake over the
flattened observation, `depth` ReZero residual blocks (x + alpha W relu(x)),
a dense policy head and a tanh value head, `width` wide. In "bfloat16" and
"float8" the inputs, weights and residual sums are bf16 and the heads are
widened to float32. No buffers.

Leaves are drawn as weights scaled by 1/sqrt(fan-in), biases by 0.1 and
the ReZero scalars by 0.5, so that every block already takes part in the
first forward pass."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import Float8, compute_dtype, outputs, precision

SCALE = {"bias": 0.1, "alpha": 0.5}


def layout(cfg):
    """Kinds "weight" (fan-in the last axis), "bias" and "alpha"."""
    S, width = cfg["boardsize"], cfg["width"]
    obs, A = 2 * S * S, S * S
    out = [("intake.dense.weight", (width, obs), "weight"), ("intake.dense.bias", (width,), "bias")]
    for i in range(cfg["depth"]):
        out += [(f"blocks.{i}.alpha", (), "alpha"),
                (f"blocks.{i}.dense.weight", (width, width), "weight"),
                (f"blocks.{i}.dense.bias", (width,), "bias")]
    out += [("policy.dense.weight", (A, width), "weight"), ("policy.dense.bias", (A,), "bias"),
            ("value.dense.weight", (1, width), "weight"), ("value.dense.bias", (1,), "bias")]
    return out


def draw(x, shape, kind):
    return x * (SCALE.get(kind) or 1 / math.sqrt(shape[-1]))


def _dense(x, p, name, prec):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if prec in ("float32", "tf32"):
        return F.linear(x, w, b)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec == "float8":
        x, w = Float8.apply(x), Float8.apply(w)
    return F.linear(x, w) + b.to(torch.bfloat16)


def forward(p, obs, valid, seats, cfg, prec="float32", train=False):
    dt = compute_dtype(prec)
    with precision(prec):
        x = _dense(obs.reshape(obs.shape[0], -1), p, "intake.dense", prec)
        for i in range(cfg["depth"]):
            block = _dense(torch.relu(x), p, f"blocks.{i}.dense", prec)
            x = x + p[f"blocks.{i}.alpha"].to(dt) * block
        y = _dense(x, p, "policy.dense", prec).float()
        v = torch.tanh(_dense(x, p, "value.dense", prec).float()[:, 0])
    return outputs(y, v, valid, seats)


def macs(cfg):
    """Entries of the matrices and biases, without the ReZero scalars."""
    S, W, D = cfg["boardsize"], cfg["width"], cfg["depth"]
    obs, A = 2 * S * S, S * S
    return (obs + 1) * W + D * (W + 1) * W + (W + 1) * A + (W + 1)


def tiny(cfg):
    return dict(cfg, width=16)
