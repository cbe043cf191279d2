"""The networks the reference computes, one module each, found by the
configuration's `net` key ("fc" where it has none), and what they share:
the precision context, the float8 rounding, the masked log-softmax policy
and the value's seat sign.

A network's module gives

- `layout(cfg)`: [(name, shape, kind)] of its leaves, in the order they are
  drawn, under the names the program's state dict uses; kind `BUFFER` is
  state that is not trained (running statistics), any other kind a
  trainable leaf;
- `draw(x, shape, kind)`: the leaf from its draw x, `prod(shape)` unit
  normals (flat), as a weight is scaled by its fan-in or a running
  variance kept positive;
- `forward(p, obs, valid, seats, cfg, prec="float32", train=False)` ->
  (logits (B,A) f32 log-probs, -inf at invalid actions; v (B,2) f32), with
  `prec` one of "float32", "tf32", "bfloat16" and "float8"; the forward
  with `train` (the learner's) writes its buffers' new values into `p`;
- `macs(cfg)`: the multiply-adds of one evaluation;
- `tiny(cfg)`: the configuration at a size a CPU test holds.

`precision` is what the products are computed in: "float32" (TF32 off),
"tf32" (float32 with TF32 on), "bfloat16" or "float8" (as "bfloat16", with
every weight and every matmul input first rounded through float8_e4m3fn;
the gradient passes the rounding unchanged). "tf32" is the float32
configurations' control on a card, "bfloat16" theirs on a CPU, and
"float8" the bfloat16 configurations' control.
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager

import torch

BUFFER = "buffer"


def module(cfg):
    """The module of the configuration's network."""
    return importlib.import_module(f"{__name__}.{cfg.get('net', 'fc')}")


def trainable(layout):
    """Names of the leaves Adam steps: every one but the buffers."""
    return [name for name, _, kind in layout if kind != BUFFER]


def buffers(layout):
    return [name for name, _, kind in layout if kind == BUFFER]


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


def compute_dtype(prec):
    return torch.float32 if prec in ("float32", "tf32") else torch.bfloat16


class Float8(torch.autograd.Function):
    """x rounded through float8_e4m3fn and back to its dtype; the gradient
    passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def outputs(y, v, valid, seats):
    """The policy head's float32 logits y (B,A) as log-probs masked to the
    valid actions, and the value v (B,) of the seat to move as (B,2), minus
    it for the other seat."""
    ninf = torch.tensor(-torch.inf, device=y.device)
    y = torch.where(valid, y, ninf)
    z = torch.where(valid, y - y.max(-1, keepdim=True).values, ninf)
    lse = torch.log(torch.where(valid, torch.exp(z), 0.0).sum(-1, keepdim=True))
    logits = torch.where(valid, z - lse, ninf)
    mover = seats.long()[:, None] == torch.arange(2, device=v.device)[None]
    return logits, torch.where(mover, v[:, None], -v[:, None])
