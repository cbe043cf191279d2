"""Space-driven network intakes and outputs. Counterpart of
boardlaw_tpu/models/heads.py, for the spaces the Hex slice uses: a Tensor
observation intake, a Masked policy output and the per-seat value head.

Layers compute in float32; the 512-wide products are plain `nn.Linear`s
(the JAX package leaves them to XLA too). Weights are initialised like
flax's: lecun-normal kernels by default, orthogonal where the JAX module
asks for it, zero biases.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def lecun_normal_(weight, generator=None):
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def orthogonal_(weight, gain=2 ** 0.5, generator=None):
    return nn.init.orthogonal_(weight, gain=gain, generator=generator)


def dense(n_in, n_out, init=lecun_normal_, generator=None):
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        init(layer.weight, generator=generator)
        layer.bias.zero_()
    return layer


class TensorIntake(nn.Module):
    """Flattens a fixed-shape observation (channels-last, C order) into one
    dense layer."""

    def __init__(self, space, width, generator=None):
        super().__init__()
        self.dense = dense(int(np.prod(space.dim)), width, generator=generator)

    def forward(self, obs):
        return self.dense(obs.reshape(obs.shape[0], -1))


class MaskedOutput(nn.Module):
    """Policy head: logits with -inf at invalid actions, then a log-softmax
    over the valid entries."""

    def __init__(self, space, width, generator=None):
        super().__init__()
        self.dense = dense(width, int(np.prod(space.dim)), generator=generator)

    def forward(self, x, valid):
        ninf = torch.tensor(-torch.inf, dtype=torch.float32, device=x.device)
        y = torch.where(valid, self.dense(x).float(), ninf)
        ymax = y.max(-1, keepdim=True).values
        z = torch.where(valid, y - ymax, ninf)
        lse = torch.log(torch.where(valid, torch.exp(z), 0.0).sum(-1, keepdim=True))
        return torch.where(valid, z - lse, ninf)


def scatter_values(v, seats):
    """Scalar value for the seat to play -> per-seat values (+v to play, -v
    for the opponent)."""
    seats = seats.long()[:, None]
    out = torch.zeros((v.shape[0], 2), dtype=v.dtype, device=v.device)
    out.scatter_(1, seats, v[:, None])
    out.scatter_(1, 1 - seats, -v[:, None])
    return out


class ValueOutput(nn.Module):
    """tanh scalar value head scattered to the two seats' +-v (the JAX
    package's one-seat form comes with the one-seat envs)."""

    def __init__(self, width, generator=None):
        super().__init__()
        self.dense = dense(width, 1, generator=generator)

    def forward(self, x, valid, seats):
        return scatter_values(torch.tanh(self.dense(x).float()[..., 0]), seats)
