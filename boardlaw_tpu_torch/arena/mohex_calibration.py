"""Calibration of agents against MoHex. Counterpart of
boardlaw_tpu/arena/mohex_calibration.py.

The distinct 2-ply openings (`initial_states`, shared with `perfect`),
labelled by MoHex self-play and cached (`reference_wins`), and agent-vs-
MoHex trials saved to the results database's `mohex_trials` (`calibrate`),
with MoHex's seat written as None. Each agent move of `play_out` takes
`draws.split()` where the JAX package splits its key. The readers return
`sql.Rows`; as in the JAX package, `calibrations` and `best_agent` take a
boardsize and read every agent's trials whatever its board.
"""
from __future__ import annotations

import json
from logging import getLogger
from pathlib import Path

import numpy as np
import torch

from .. import mohex, sql
from ..draws import Draws
from ..envs import hex
from . import common
from .perfect import initial_states  # noqa: F401

log = getLogger(__name__)

DATA = Path("output/experiments/mohex.json")


def play_out(world, agents, draws=None, max_plies=None):
    """Play fixed seats (agent i at seat i) until every game ends; returns
    the winning seat of each env (-1 where a game did not end)."""
    draws = draws if draws is not None else Draws(0, world.device)
    B = world.n_envs
    done = np.zeros(B, bool)
    winners = np.full(B, -1)
    max_plies = max_plies or 2 * world.boardsize ** 2

    for _ in range(max_plies):
        if done.all():
            break
        seats = world.seats.cpu().numpy()
        for i, agent in enumerate(agents):
            mask = (seats == i) & ~done
            if not mask.any():
                continue
            decisions = agent(world, draws.split(), eval=True)
            stepped, tr = world.step(decisions["actions"])
            world = hex._where(torch.as_tensor(mask, device=world.device), stepped, world)
            terminal = tr.terminal.cpu().numpy() & mask
            rewards = tr.rewards.cpu().numpy()
            winners[terminal] = rewards[terminal].argmax(-1)
            done |= terminal
            seats = world.seats.cpu().numpy()
    return winners


def reference_wins(boardsize=7, chunk=8, device=None):
    """The winning seat of every opening under MoHex self-play, cached to
    `DATA`. Needs the MoHex binary."""
    DATA.parent.mkdir(parents=True, exist_ok=True)
    if DATA.exists():
        return np.asarray(json.loads(DATA.read_text()), int)
    if not mohex.available():
        raise RuntimeError("MoHex binary not available; cannot build reference wins")

    world = initial_states(boardsize, device)
    agent = mohex.MoHexAgent()
    wins = np.full(world.n_envs, -1)
    try:
        for i in range(0, world.n_envs, chunk):
            sub = common._take(world, slice(i, i + chunk))
            wins[i:i + chunk] = play_out(sub, [agent, agent])
    finally:
        agent.close()
    DATA.write_text(json.dumps([int(w) for w in wins]))
    return wins


def calibrate(agent_id, n_envs=16, draws=None, device=None, **mohex_kwargs):
    """Agent-vs-MoHex games in both seat orders from the empty board, saved
    to `mohex_trials` (MoHex's seat as None); returns the results."""
    if not mohex.available():
        raise RuntimeError("MoHex binary not available")
    row = sql.agent_query().row(agent_id)
    ag = common.sql_agent(agent_id, device=device)
    world = hex.Hex.initial(n_envs, int(row.boardsize), device=ag.device)
    mhx = mohex.MoHexAgent(**mohex_kwargs)
    try:
        results = common.evaluate(world, {"agent": ag, "mohex": mhx}, draws=draws)
    finally:
        mhx.close()
    rows = []
    for r in results:
        black, white = r["names"]
        rows.append((agent_id if black == "agent" else None,
                     agent_id if white == "agent" else None,
                     r["wins"][0], r["wins"][1], r["moves"], r["times"]))
    sql.save_mohex_trials(rows)
    return results


def calibrations(boardsize):
    """Each agent's win rate against MoHex over all its `mohex_trials`:
    `sql.Rows` of (agent_id, winrate, games), agents in id order. Reads
    every agent's trials; `boardsize` is not applied (as in the JAX
    package)."""
    columns = ["agent_id", "winrate", "games"]
    t = sql.mohex_trial_query()
    black, white = t.black_agent.astype(float), t.white_agent.astype(float)
    ids = sorted({int(a) for a in np.concatenate([black, white]) if np.isfinite(a)})
    rows = []
    for aid in ids:
        as_black, as_white = black == aid, white == aid
        wins = t.black_wins[as_black].sum() + t.white_wins[as_white].sum()
        games = (t.black_wins[as_black].sum() + t.white_wins[as_black].sum()
                 + t.black_wins[as_white].sum() + t.white_wins[as_white].sum())
        rows.append((aid, float(wins / max(games, 1)), float(games)))
    return sql.Rows(columns, rows)


def best_agent(boardsize):
    """The agent with the highest win rate against MoHex (the last of the
    best in id order); None where there are no trials."""
    c = calibrations(boardsize)
    if len(c) == 0:
        return None
    return int(c.agent_id[np.argsort(c.winrate, kind="stable")[-1]])
