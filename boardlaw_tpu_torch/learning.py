"""Training utilities. Counterpart of boardlaw_tpu/learning.py; this slice
carries `mix` only (returns, entropy and the noise scale come with the
learner)."""
from __future__ import annotations

import torch


def mix(world, draws, T=2500):
    """Decorrelate envs by random-walking them T steps: each step plays a
    uniform valid action per env, drawn as argmax(logits + Gumbel) from
    `draws.gumbel`. Runs on the world's device."""
    for _ in range(T):
        valid = world.valid
        logits = torch.where(valid, 0.0, -torch.inf)
        actions = torch.argmax(logits + draws.gumbel(valid.shape), -1)
        world, _ = world.step(actions)
    return world
