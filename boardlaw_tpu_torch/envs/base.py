"""World protocol: the contract every vectorized game implements.

Counterpart of boardlaw_tpu/envs/base.py. A world is a dataclass of tensors
with a leading env axis:

    World.initial(n_envs, ..., device=None) -> World
    world.step(actions)                     -> (World, Transition)
    world.obs                               -> (n_envs, *obs_space.dim) f32
    world.valid                             -> (n_envs, n_actions) bool
    world.seats                             -> (n_envs,) int32

Terminal envs auto-reset inside ``step``; the pre-reset outcome is reported in
the returned ``Transition``.
"""
from __future__ import annotations

from collections import namedtuple
from dataclasses import dataclass

import torch


@dataclass
class Transition:
    """terminal: (n_envs,) bool; rewards: (n_envs, n_seats) f32."""

    terminal: torch.Tensor
    rewards: torch.Tensor


# Space descriptors, used by the space-driven head factories (models/heads.py).
Empty = namedtuple("Empty", ())
Discrete = namedtuple("Discrete", ("dim",))
Masked = namedtuple("Masked", ("dim",))
Vector = namedtuple("Vector", ("dim",))
Tensor = namedtuple("Tensor", ("dim",))
