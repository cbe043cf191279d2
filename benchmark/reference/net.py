"""The plain policy/value network: a dense intake over the flattened
observation, `depth` ReZero residual blocks (x + alpha W relu(x)), a masked
log-softmax policy and a tanh value for the seat to move (minus it for the
other seat). The weights are a dict of tensors under the names the
program's state dict uses.

`precision` is what the products are computed in: "float32" (TF32 off),
"tf32" (float32 with TF32 on), "bfloat16" (inputs, weights and residual
sums in bf16, the heads widened to float32) or "float8" (as "bfloat16",
with every weight and every matmul input first rounded through
float8_e4m3fn; the gradient passes the rounding unchanged). "tf32" is the
float32 configurations' control on a card, "bfloat16" theirs on a CPU, and
"float8" the bfloat16 configurations' control.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F


def layout(boardsize, width, depth):
    """[(name, shape, kind)] of the network's leaves, kind one of "weight"
    (fan-in the last axis), "bias" and "alpha"."""
    obs, A = 2 * boardsize * boardsize, boardsize * boardsize
    out = [("intake.dense.weight", (width, obs), "weight"), ("intake.dense.bias", (width,), "bias")]
    for i in range(depth):
        out += [(f"blocks.{i}.alpha", (), "alpha"),
                (f"blocks.{i}.dense.weight", (width, width), "weight"),
                (f"blocks.{i}.dense.bias", (width,), "bias")]
    out += [("policy.dense.weight", (A, width), "weight"), ("policy.dense.bias", (A,), "bias"),
            ("value.dense.weight", (1, width), "weight"), ("value.dense.bias", (1,), "bias")]
    return out


@contextmanager
def precision(name):
    """TF32 on for "tf32", off otherwise, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Float8(torch.autograd.Function):
    """x rounded through float8_e4m3fn and back to its dtype; the gradient
    passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def _dense(x, p, name, prec):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if prec in ("float32", "tf32"):
        return F.linear(x, w, b)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec == "float8":
        x, w = _Float8.apply(x), _Float8.apply(w)
    return F.linear(x, w) + b.to(torch.bfloat16)


def forward(p, obs, valid, seats, depth, prec="float32"):
    """-> (logits (B,A) f32 log-probs, -inf at invalid actions; v (B,2) f32)."""
    dt = torch.float32 if prec in ("float32", "tf32") else torch.bfloat16
    with precision(prec):
        x = _dense(obs.reshape(obs.shape[0], -1), p, "intake.dense", prec)
        for i in range(depth):
            block = _dense(torch.relu(x), p, f"blocks.{i}.dense", prec)
            x = x + p[f"blocks.{i}.alpha"].to(dt) * block
        y = _dense(x, p, "policy.dense", prec).float()
        v = torch.tanh(_dense(x, p, "value.dense", prec).float()[:, 0])
    ninf = torch.tensor(-torch.inf, device=y.device)
    y = torch.where(valid, y, ninf)
    z = torch.where(valid, y - y.max(-1, keepdim=True).values, ninf)
    lse = torch.log(torch.where(valid, torch.exp(z), 0.0).sum(-1, keepdim=True))
    logits = torch.where(valid, z - lse, ninf)
    mover = seats.long()[:, None] == torch.arange(2, device=v.device)[None]
    return logits, torch.where(mover, v[:, None], -v[:, None])
