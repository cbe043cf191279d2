"""Space-driven network intakes and outputs. Counterpart of
boardlaw_tpu/models/heads.py: the observation and action spaces
(envs/base.py: Empty, Vector, Tensor, dicts of spaces; Discrete, Masked)
pick the intake and output modules (`intake_module`, `output_module`).

Every layer has a compute `dtype`, as flax's `Dense(dtype=...)` has: the
parameters stay float32, inputs and weights are cast to `dtype` per call,
the product runs in `dtype` and the bias is added after it, in `dtype` (the
product rounded, then the sum: flax's order). In float32 that is one
`F.linear` with its bias. The heads upcast to float32 before the masked
log-softmax and the tanh. Weights are initialised like flax's: lecun-normal
kernels by default, orthogonal where the JAX module asks for it, zero
biases.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import count

SYNC_NINF = "sync.heads.ninf"  # counter (utils.profiling)


def lecun_normal_(weight, generator=None):
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def orthogonal_(weight, gain=2 ** 0.5, generator=None):
    return nn.init.orthogonal_(weight, gain=gain, generator=generator)


class Dense(nn.Linear):
    """flax's `Dense(dtype=...)`: float32 parameters, computed in `dtype`."""

    def __init__(self, n_in, n_out, dtype=torch.float32, init=lecun_normal_, generator=None):
        super().__init__(n_in, n_out)
        self.dtype = dtype
        with torch.no_grad():
            init(self.weight, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _size(space):
    return int(np.prod(space.dim))


class EmptyIntake(nn.Module):
    """No observation: a learned (width,) bias for every env."""

    def __init__(self, space, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, obs):
        return self.bias.to(self.dtype)[None].expand(obs.shape[0], -1)


class TensorIntake(nn.Module):
    """Flattens a fixed-shape observation (channels-last, C order) into one
    dense layer."""

    def __init__(self, space, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.dense = Dense(_size(space), width, dtype, generator=generator)

    def forward(self, obs):
        return self.dense(obs.reshape(obs.shape[0], -1))


class VectorIntake(TensorIntake):
    """A (B, dim) observation through one dense layer (the flatten is the
    identity on it)."""


class ConcatIntake(nn.Module):
    """A dict of spaces: each key's intake (`intakes[k]`, flax's
    `intake_{k}`), their outputs concatenated in the dict's order through
    one dense core."""

    def __init__(self, space, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.intakes = nn.ModuleDict(
            {k: intake_module(v, width, dtype, generator=generator) for k, v in space.items()})
        self.dense = Dense(width * len(space), width, dtype, generator=generator)

    def forward(self, obs):
        return self.dense(torch.cat([m(obs[k]) for k, m in self.intakes.items()], -1))


def intake_module(space, width, dtype=torch.float32, generator=None):
    """The intake for an observation space: a dict of spaces, Empty, Vector
    or Tensor."""
    if isinstance(space, dict):
        return ConcatIntake(space, width, dtype, generator=generator)
    cls = {"Empty": EmptyIntake, "Vector": VectorIntake,
           "Tensor": TensorIntake}.get(type(space).__name__)
    if cls is None:
        raise ValueError(f"Can't handle {space}")
    return cls(space, width, dtype, generator=generator)


class DiscreteOutput(nn.Module):
    """Policy head over every action: a log-softmax in float32."""

    def __init__(self, space, width, dtype=torch.float32, generator=None):
        super().__init__()
        dim = _size(space) if hasattr(space, "dim") else int(space)
        self.dense = Dense(width, dim, dtype, generator=generator)

    def forward(self, x, valid=None):
        return torch.log_softmax(self.dense(x).float(), -1)


class MaskedOutput(nn.Module):
    """Policy head: logits with -inf at invalid actions, then a log-softmax
    over the valid entries, in float32. The -inf is copied from pageable
    host memory, which on a card waits for the device (`SYNC_NINF`)."""

    def __init__(self, space, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.dense = Dense(width, _size(space), dtype, generator=generator)

    def forward(self, x, valid):
        count(SYNC_NINF)
        ninf = torch.tensor(-torch.inf, dtype=torch.float32, device=x.device)
        y = torch.where(valid, self.dense(x).float(), ninf)
        ymax = y.max(-1, keepdim=True).values
        z = torch.where(valid, y - ymax, ninf)
        lse = torch.log(torch.where(valid, torch.exp(z), 0.0).sum(-1, keepdim=True))
        return torch.where(valid, z - lse, ninf)


def output_module(space, width, dtype=torch.float32, generator=None):
    """The policy head for an action space: Discrete or Masked."""
    cls = {"Discrete": DiscreteOutput, "Masked": MaskedOutput}.get(type(space).__name__)
    if cls is None:
        raise ValueError(f"Can't handle {space}")
    return cls(space, width, dtype, generator=generator)


def scatter_values(v, seats):
    """Scalar value for the seat to play -> per-seat values (+v to play, -v
    for the opponent)."""
    seats = seats.long()[:, None]
    out = torch.zeros((v.shape[0], 2), dtype=v.dtype, device=v.device)
    out.scatter_(1, seats, v[:, None])
    out.scatter_(1, 1 - seats, -v[:, None])
    return out


class ValueOutput(nn.Module):
    """tanh scalar value head, in float32: (B,1) for one-seat games, else
    scattered to the two seats' +-v."""

    def __init__(self, width, n_seats=2, dtype=torch.float32, generator=None):
        super().__init__()
        self.n_seats = n_seats
        self.dense = Dense(width, 1, dtype, generator=generator)

    def forward(self, x, valid, seats):
        v = torch.tanh(self.dense(x).float()[..., 0])
        if self.n_seats == 1:
            return v[:, None]
        return scatter_values(v, seats)
