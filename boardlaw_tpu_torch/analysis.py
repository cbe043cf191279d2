"""Rollouts and recordings for analysis and demos. Counterpart of
boardlaw_tpu/analysis.py.

`rollout` plays one agent per seat over a batch of worlds, every agent
acting on the full batch each ply with the seat owner's action kept, and
returns the stacked trace; `combine_decisions` reassembles each agent's
masked decisions into dense (T, B, ...) numpy arrays; `record_worlds`
renders a trace's boards to video frames (`utils.recording`, matplotlib
imported where a frame is drawn). Each agent call takes `draws.split()`
where the JAX package splits its key.
"""
from __future__ import annotations

from logging import getLogger

import numpy as np
import torch

from . import utils
from .draws import Draws
from .utils import recording

log = getLogger(__name__)


def rollout(world, agents, draws=None, n_steps=None, n_trajs=None, n_reps=None, **kwargs):
    """Play `agents` (one per seat) until the given number of steps,
    finished trajectories or finishes of every env. Returns a dict whose
    `actions` (T, B), `transitions` and `worlds` are stacked on a leading
    time axis, and `decisions`: each agent's decisions with their
    ownership masks (`combine_decisions`)."""
    if sum(x is not None for x in (n_steps, n_trajs, n_reps)) != 1:
        raise ValueError("Specify exactly one of n_steps, n_trajs, n_reps")
    draws = draws if draws is not None else Draws(0, world.device)
    B = world.n_envs

    trace = []
    dtrace = []
    steps, trajs = 0, 0
    reps = np.zeros(B)

    while True:
        seats = world.seats.cpu().numpy()
        decisions, masks = {}, {}
        actions = torch.zeros((B,), dtype=torch.int32, device=world.device)
        for i, agent in enumerate(agents):
            mask = seats == i
            if not mask.any():
                continue
            d = agent(world, draws.split(), **kwargs)
            decisions[i] = d
            masks[i] = mask
            actions = torch.where(torch.as_tensor(mask, device=world.device),
                                  d["actions"].to(torch.int32), actions)

        world, transitions = world.step(actions)
        trace.append({"actions": actions, "transitions": transitions, "worlds": world})
        dtrace.append({i: {**decisions[i], "mask": masks[i]} for i in decisions})

        steps += 1
        if n_steps and steps >= n_steps:
            break
        terminal = transitions.terminal.cpu().numpy()
        trajs += int(terminal.sum())
        if n_trajs and trajs >= n_trajs:
            break
        reps += terminal
        if n_reps and (reps >= n_reps).all():
            break

    out = utils.stack(trace)
    out["decisions"] = combine_decisions(dtrace, B)
    return out


def _numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _expand(exemplar, B):
    """A default-filled full-batch array for a masked decision leaf (NaN
    for floats, -1 otherwise)."""
    x = _numpy(exemplar)
    default = np.nan if np.issubdtype(x.dtype, np.floating) else -1
    return np.full((B,) + x.shape[1:], default, x.dtype)


def combine_decisions(dtrace, B):
    """Each agent's per-step decisions as dense (T, B, ...) numpy arrays,
    filled where the agent owned the env, with the ownership `mask`."""
    agents = {a for d in dtrace for a in d}
    results = {}
    for a in agents:
        exemplar = next(d[a] for d in dtrace if a in d)
        steps = []
        for d in dtrace:
            expanded = {k: _expand(v, B) for k, v in exemplar.items() if k != "mask"}
            if a in d:
                mask = np.asarray(d[a]["mask"])
                for k in expanded:
                    expanded[k][mask] = _numpy(d[a][k])[mask]
                expanded["mask"] = mask
            else:
                expanded["mask"] = np.zeros(B, bool)
            steps.append(expanded)
        results[str(a)] = {k: np.stack([s[k] for s in steps]) for k in steps[0]}
    return results


def record_worlds(worlds_trace, n_envs=4, fps=1):
    """Render a (T, B, ...) Hex world trace, its first `n_envs` envs side by
    side, to an `Encoder` of T frames."""
    from .envs import hex

    boards = worlds_trace.board[:, :n_envs].cpu().numpy()

    def frame(t):
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, boards.shape[1], squeeze=False)
        for e in range(boards.shape[1]):
            hex.plot_board(hex.color_board(boards[t, e]), ax=axes[0, e])
        return fig

    with recording.Encoder(fps=fps) as enc:
        for t in range(boards.shape[0]):
            enc(frame(t))
    return enc


def record(world, agents, n_envs=4, draws=None, **kwargs):
    """Roll out games and record them."""
    trace = rollout(world, agents, draws=draws, **kwargs)
    return record_worlds(trace["worlds"], n_envs=n_envs)
