"""Policy/value networks. Counterpart of boardlaw_tpu/models/networks.py: a
fully-connected ReZero residual tower over the observation, with a policy
head (masked softmax for Hex) and a tanh value head.

`dtype` is the compute type of every layer, float32 (the default) or
bfloat16 (the JAX flagship's): float32 parameters, the tower and its
residual sums in `dtype`, the heads' softmax and tanh in float32
(models/heads.py). Float32 runs with TF32 off for both matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`, set by `FCModel`): TF32 keeps
about three decimal digits, and the JAX reference computes these products in
full float32.
"""
from __future__ import annotations

import torch
from torch import nn

from . import heads
from ..utils import resolve_device


class ReZeroResidual(nn.Module):
    """x + alpha * W relu(x) in `dtype` (alpha, float32, cast to it),
    alpha initialised to 0."""

    def __init__(self, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.dense = heads.Dense(width, width, dtype, init=heads.orthogonal_,
                                 generator=generator)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x + self.alpha.to(self.dtype) * self.dense(torch.relu(x))


class FCModel(nn.Module):
    """Intake -> depth x ReZero -> (masked policy, per-seat tanh value).

    Call with (obs, valid, seats); returns {'logits': (B,A) f32 log-probs with
    -inf at invalid actions, 'v': (B, n_seats) f32}. The intake and policy
    head are the spaces' (`heads.intake_module`, `heads.output_module`);
    `dtype` is the compute type (torch.float32 or torch.bfloat16). Weights
    are float32, made on the CPU from `generator` (or torch's default one)
    and then moved to `device`, so a seed gives the same weights on every
    device.
    """

    def __init__(self, obs_space, action_space, width=256, depth=64, n_seats=2,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.intake = heads.intake_module(obs_space, width, dtype, generator=generator)
        self.blocks = nn.ModuleList(
            [ReZeroResidual(width, dtype, generator=generator) for _ in range(depth)])
        self.policy = heads.output_module(action_space, width, dtype, generator=generator)
        self.value = heads.ValueOutput(width, n_seats, dtype, generator=generator)
        self.to(device)

    def forward(self, obs, valid, seats):
        x = self.intake(obs)
        for block in self.blocks:
            x = block(x)
        return {"logits": self.policy(x, valid), "v": self.value(x, valid, seats)}


def make_eval_fn(model):
    """Close a model over its weights as a world evaluator:
    ``eval_fn(world) -> {'logits', 'v'}``, the interface MCTS consumes."""

    @torch.no_grad()
    def eval_fn(world):
        return model(world.obs, world.valid, world.seats)

    return eval_fn
