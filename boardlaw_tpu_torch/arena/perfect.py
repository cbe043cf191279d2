"""Exact perfect-play anchoring for small boards. Counterpart of
boardlaw_tpu/arena/perfect.py.

Small boards are exactly solvable: a memoized minimax over the port's own
`Hex.step` (one A-batched step expands every action of a state, so the
oracle and the environment agree by construction), the exact label of every
2-ply opening, and a `PerfectAgent` that plays in `arena.common.evaluate`.
3x3 solves in seconds (about 4k reachable states). The expansions run on
`device`, the card unless the caller asks for another.
"""
from __future__ import annotations

import json
from logging import getLogger
from pathlib import Path

import numpy as np
import torch

from ..draws import Draws
from ..envs import hex
from ..utils import resolve_device

log = getLogger(__name__)

DATA = Path("output/experiments/perfect")


class Solver:
    """Memoized exact minimax over Hex states, one env step batch per state.

    `value(board, seat)` is +1 if the player to move wins with perfect play,
    -1 otherwise (Hex has no draws); `action_values` gives the exact value of
    every legal move."""

    def __init__(self, boardsize=3, device=None):
        self.boardsize = boardsize
        self.A = boardsize * boardsize
        self.device = resolve_device(device)
        self._memo = {}

    def _expand(self, board, seat):
        A = self.A
        world = hex.Hex(
            board=torch.tensor(board, device=self.device)[None].expand(
                (A,) + board.shape).clone(),
            seats=torch.full((A,), seat, dtype=torch.int32, device=self.device))
        new, tr = world.step(torch.arange(A, dtype=torch.int32, device=self.device))
        # the valid mask comes from the env, not `board == 0` flattened:
        # actions are in the acting player's frame, transposed for seat 1
        return tuple(x.cpu().numpy() for x in (world.valid[0], new.board, new.seats,
                                               tr.terminal, tr.rewards))

    def action_values(self, board, seat, alpha_beta=True):
        """Exact value per legal action (mover-frame indices, transposed for
        seat 1) from the mover's perspective -> (A,) float, NaN at illegal
        actions (and, with `alpha_beta`, after the first winning move)."""
        board = np.asarray(board, np.uint8)
        seat = int(seat)
        valid, boards, seats, term, rew = self._expand(board, seat)
        vals = np.full(self.A, np.nan, np.float32)
        for a in np.flatnonzero(valid):
            if term[a]:
                # in Hex a move can only complete the mover's own connection
                v = 1.0 if rew[a, seat] == 1 else -1.0
            else:
                v = -self.value(boards[a], int(seats[a]))
            vals[a] = v
            if alpha_beta and v == 1.0:
                break
        return vals

    def value(self, board, seat):
        board = np.asarray(board, np.uint8)
        key = (board.tobytes(), int(seat))
        if key not in self._memo:
            self._memo[key] = float(np.nanmax(self.action_values(board, seat)))
        return self._memo[key]

    def optimal_actions(self, board, seat):
        """All exactly-optimal moves (indices)."""
        vals = self.action_values(board, seat, alpha_beta=False)
        return np.flatnonzero(vals == np.nanmax(vals))

    def states_solved(self):
        return len(self._memo)


class PerfectAgent:
    """An agent over the exact solver (host-side, like the GTP agents): a
    uniformly random exactly-optimal move from its own numpy generator, so
    repeated games vary while never conceding value."""

    def __init__(self, solver: Solver, seed=0):
        self.solver = solver
        self.rng = np.random.default_rng(seed)

    def __call__(self, world, draws=None, eval=False):
        boards = world.board.cpu().numpy()
        seats = world.seats.cpu().numpy()
        B = boards.shape[0]
        A = self.solver.A
        actions = np.zeros(B, np.int32)
        logits = np.full((B, A), -np.inf, np.float32)
        values = np.zeros((B, world.n_seats), np.float32)
        for b in range(B):
            if (boards[b] != 0).all():
                continue  # finished board (frozen env); any action is unused
            opts = self.solver.optimal_actions(boards[b], seats[b])
            actions[b] = self.rng.choice(opts)
            logits[b, opts] = -np.log(len(opts))
            v = self.solver.value(boards[b], seats[b])
            values[b, seats[b] % world.n_seats] = v
            values[b, (seats[b] + 1) % world.n_seats] = -v
        dev = world.device
        return {"actions": torch.as_tensor(actions, device=dev),
                "logits": torch.as_tensor(logits, device=dev),
                "v": torch.as_tensor(values, device=dev)}


def initial_states(boardsize=7, device=None):
    """All 2-ply openings that are distinct up to white's frame
    transposition (the JAX package's arena/mohex_calibration.py
    `initial_states`)."""
    count = boardsize ** 4
    first = np.arange(count) // boardsize ** 2
    second = np.arange(count) % boardsize ** 2
    rows, cols = first // boardsize, first % boardsize
    mask = cols * boardsize + rows != second

    world = hex.Hex.initial(int(mask.sum()), boardsize, device=device)
    for acts in (first[mask], second[mask]):
        world, _ = world.step(torch.as_tensor(acts, dtype=torch.int32, device=world.device))
    return world


def exact_opening_wins(boardsize=3, cache=True, device=None):
    """For every distinct 2-ply opening, the exact winning seat under
    perfect play. Returns (winners (N,) int array, openings world); the
    labels are cached under `DATA`, as the JAX package caches them."""
    path = DATA / f"openings_b{boardsize}.json"
    world = initial_states(boardsize, device)
    if cache and path.exists():
        return np.asarray(json.loads(path.read_text()), int), world

    solver = Solver(boardsize, device)
    boards = world.board.cpu().numpy()
    seats = world.seats.cpu().numpy()
    winners = np.empty(world.n_envs, int)
    for i in range(world.n_envs):
        mover = int(seats[i])
        winners[i] = mover if solver.value(boards[i], seats[i]) > 0 else 1 - mover
    if cache:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps([int(w) for w in winners]))
    log.info(f"solved {solver.states_solved()} states for b{boardsize} openings")
    return winners, world


def calibrate_exact(agent, boardsize=3, n_envs=64, draws=None, device=None):
    """The perfect-play win rate of an agent: both seat orders from the
    empty board against `PerfectAgent`. Returns the evaluate() results, the
    aggregate win rate and the games."""
    from . import common

    device = resolve_device(device)
    solver = Solver(boardsize, device)
    world = hex.Hex.initial(n_envs, boardsize, device=device)
    results = common.evaluate(world, {"agent": agent, "perfect": PerfectAgent(solver)},
                              draws=draws if draws is not None else Draws(0, device))
    wins = games = 0.0
    for r in results:
        for name, w in zip(r["names"], r["wins"]):
            if name == "agent":
                wins += w
        games += r["games"]
    return {"results": results, "winrate": wins / max(games, 1.0), "games": games}
