"""The self-play actor step. Counterpart of the actor half of
boardlaw_tpu/train.py: `actor_record` is one search per env, the improved
root policy, a categorical draw from it and one `Hex.step`, returning the new
worlds and the replay record of the pre-step state.

The learner step (losses, Adam, the circular buffer, reward-to-go) comes
with the next slice, and with it the learner's config fields.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from . import learning
from .draws import Draws
from .envs import hex
from .mcts import MCTSConfig, mcts as run_mcts, root as mcts_root, n_leaves
from .models.networks import FCModel, make_eval_fn


@dataclass(frozen=True)
class TrainConfig:
    """The fields that change what the actor step computes. The defaults are
    the JAX package's production settings for boards of 7 and up: K=8
    leaves per pass, grow passes, the prefix backup."""

    boardsize: int
    width: int
    depth: int
    n_envs: int = 32 * 1024
    n_nodes: int = 64
    c_puct: float = 1 / 16
    noise_eps: float = 0.25
    mix_steps: int = 2500
    # replay logits/prior storage; losses upcast to f32
    buffer_dtype: str = "bfloat16"
    leaves_per_pass: int = 8
    solve_iters: int = 6
    solve_accel: bool = True
    grow_passes: bool = True
    backup_mode: str = "prefix"

    def mcts_config(self):
        return MCTSConfig(
            n_nodes=self.n_nodes,
            c_puct=self.c_puct,
            noise_eps=self.noise_eps,
            leaves_per_pass=self.leaves_per_pass,
            solve_iters=self.solve_iters,
            solve_accel=self.solve_accel,
            grow_passes=self.grow_passes,
            backup_mode=self.backup_mode,
        )


def build_model(cfg: TrainConfig, device=None, generator=None):
    world = hex.Hex.initial(1, cfg.boardsize, device="cpu")
    return FCModel(world.obs_space, world.action_space, width=cfg.width, depth=cfg.depth,
                   device=device, generator=generator)


def init_worlds(cfg: TrainConfig, draws: Draws):
    """`cfg.n_envs` decorrelated worlds: `learning.mix` over fresh boards, on
    the device of `draws`."""
    worlds = hex.Hex.initial(cfg.n_envs, cfg.boardsize, device=draws.device)
    return learning.mix(worlds, draws, cfg.mix_steps)


@torch.no_grad()
def actor_record(cfg: TrainConfig, model, worlds, draws: Draws, return_tree=False):
    """One self-play step for every env: search, act, step. Returns the new
    worlds and the replay record of the pre-step state (and the search tree
    with `return_tree`)."""
    tree = run_mcts(worlds, make_eval_fn(model), draws, cfg.mcts_config())
    r = mcts_root(tree)
    actions = torch.argmax(r["logits"] + draws.gumbel(r["logits"].shape), -1)
    new_worlds, transition = worlds.step(actions)
    bdt = getattr(torch, cfg.buffer_dtype)
    record = {
        "worlds": worlds,
        "logits": r["logits"].to(bdt),
        "prior": r["prior"].to(bdt),
        "v": r["v"].float(),
        "n_leaves": n_leaves(tree).to(torch.int32),
        "terminal": transition.terminal,
        "rewards": transition.rewards.float(),
    }
    return (new_worlds, record, tree) if return_tree else (new_worlds, record)


def make_actor(cfg: TrainConfig, model):
    """`actor_record` closed over a config and a model:
    ``actor(worlds, draws) -> (new_worlds, record)``."""
    return partial(actor_record, cfg, model)
