"""Policy/value networks. Counterpart of boardlaw_tpu/models/networks.py: a
fully-connected ReZero residual tower over the flattened board, with a
masked-softmax policy head and a tanh value head.

Computes in float32 with TF32 off for both matmuls and cuDNN
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
    """x + alpha * W relu(x), alpha initialised to 0."""

    def __init__(self, width, generator=None):
        super().__init__()
        self.dense = heads.dense(width, width, init=heads.orthogonal_, generator=generator)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x + self.alpha * self.dense(torch.relu(x))


class FCModel(nn.Module):
    """Intake -> depth x ReZero -> (masked policy, per-seat tanh value).

    Call with (obs, valid, seats); returns {'logits': (B,A) f32 log-probs with
    -inf at invalid actions, 'v': (B,2) f32}. Weights are made on the
    CPU from `generator` (or torch's default one) and then moved to `device`,
    so a seed gives the same weights on every device.
    """

    def __init__(self, obs_space, action_space, width=256, depth=64, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.intake = heads.TensorIntake(obs_space, width, generator=generator)
        self.blocks = nn.ModuleList(
            [ReZeroResidual(width, generator=generator) for _ in range(depth)])
        self.policy = heads.MaskedOutput(action_space, width, generator=generator)
        self.value = heads.ValueOutput(width, generator=generator)
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
