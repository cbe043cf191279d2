"""Synthetic games with known values, for search correctness checks.
Counterpart of boardlaw_tpu/envs/validation.py.

Each game plants exact logits and values on the world itself, so
`ProxyAgent` can stand in for a network and a search's root value can be
held against the analytic one:

  Win              one step, one seat, an instant +1; root value 1
  WinnerLoser      two seats, the first wins +1, the second -1
  All              submit action 1 every turn for `length` turns; the root
                   value is 2^-length for each seat
  SequentialMatrix one-shot 2x2 matrix games played in turn, among them
                   the prisoner's dilemma

The worlds are dataclasses of tensors with a leading env axis and a `device`
property, like `hex.Hex`, so the search can expand and gather them. The
agents take the port's `agent(world, draws=None)` form; every random draw
goes through `Draws` (a categorical draw is argmax(logits + Gumbel noise),
which is how `jax.random.categorical` draws).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .base import Masked, Tensor, Transition
from ..utils import resolve_device


def uniform_logits(valid):
    return torch.log(valid.to(torch.float32) / valid.sum(-1, keepdim=True))


def _categorical(logits, draws):
    return torch.argmax(logits + draws.gumbel(logits.shape), -1)


# --------------------------------------------------------------------------
# Agents
# --------------------------------------------------------------------------

class ProxyAgent:
    """Returns the logits and values planted on the world."""

    def __call__(self, world, draws=None):
        return {"logits": world.logits, "v": world.v}


class RandomAgent:
    """Uniform over the valid actions with zero value; with `draws`, also a
    uniform random valid action."""

    def __call__(self, world, draws=None):
        B = world.valid.shape[0]
        out = {
            "logits": uniform_logits(world.valid),
            "v": torch.zeros((B, world.n_seats), dtype=torch.float32, device=world.device),
        }
        if draws is not None:
            out["actions"] = _categorical(out["logits"], draws)
        return out


class MonteCarloAgent:
    """Estimates each action's value by uniform random playouts.

    Each rollout takes its own stream, `draws.split()`, and draws one
    categorical for its first move and one for each later step, up to
    `max_steps` steps in all, while any env's game is still going; the
    action comes from the parent stream after the rollouts. The JAX package
    makes the same draws in the same order (its rollout a `lax.while_loop`,
    here a host loop that checks once a step whether any game goes on)."""

    def __init__(self, n_rollouts, temperature=1.0, max_steps=256):
        self.n_rollouts = n_rollouts
        self.temperature = temperature
        self.max_steps = max_steps

    def rollout(self, world, draws):
        """-> (rewards (B, n_seats) summed until each env's game ended,
        first actions (B,))."""
        first_actions = _categorical(uniform_logits(world.valid), draws)
        world, tr = world.step(first_actions)
        reward = tr.rewards
        live = ~tr.terminal
        t = 1
        while t < self.max_steps and bool(live.any()):
            actions = _categorical(uniform_logits(world.valid), draws)
            world, tr = world.step(actions)
            reward = reward + tr.rewards * live[:, None]
            live = live & ~tr.terminal
            t += 1
        return reward, first_actions

    def __call__(self, world, draws):
        B, A = world.valid.shape
        dev = world.device
        envs = torch.arange(B, device=dev)

        totals = torch.zeros((B, A, world.n_seats), device=dev)
        counts = torch.zeros((B, A, world.n_seats), device=dev)
        for _ in range(self.n_rollouts):
            r, a = self.rollout(world, draws.split())
            totals[envs, a] += r
            counts[envs, a] += 1.0
        means = torch.where(counts > 0, totals / counts.clamp_min(1), 0.0)

        seat_means = means[envs, :, world.seats.long()]
        logits = torch.log_softmax(self.temperature * seat_means, -1)
        logits = torch.where(world.valid, logits, -torch.inf)
        return {
            "logits": logits,
            "actions": _categorical(logits, draws),
            "v": totals.sum(-2) / counts.sum(-2).clamp_min(1),
        }


# --------------------------------------------------------------------------
# Games
# --------------------------------------------------------------------------

def _ones(shape, dtype, like):
    return torch.ones(shape, dtype=dtype, device=like.device)


@dataclass
class Win:
    """One-step one-seat win (+1)."""

    envs: torch.Tensor  # (B,) int64

    @classmethod
    def initial(cls, n_envs=1, device=None):
        return cls(envs=torch.arange(n_envs, device=resolve_device(device)))

    @property
    def device(self):
        return self.envs.device

    @property
    def n_envs(self):
        return self.envs.shape[0]

    @property
    def n_seats(self):
        return 1

    @property
    def obs_space(self):
        return Tensor((1,))

    @property
    def action_space(self):
        return Masked(1)

    @property
    def valid(self):
        return _ones((self.n_envs, 1), torch.bool, self.envs)

    @property
    def seats(self):
        return torch.zeros((self.n_envs,), dtype=torch.int32, device=self.device)

    @property
    def obs(self):
        return torch.zeros((self.n_envs, 1), device=self.device)

    @property
    def logits(self):
        return uniform_logits(self.valid)

    @property
    def v(self):
        return _ones((self.n_envs, 1), torch.float32, self.envs)

    def step(self, actions):
        return self, Transition(_ones((self.n_envs,), torch.bool, self.envs),
                                _ones((self.n_envs, 1), torch.float32, self.envs))


@dataclass
class WinnerLoser:
    """The first seat wins each round (+1), the second loses (-1)."""

    seats: torch.Tensor  # (B,) int32

    @classmethod
    def initial(cls, n_envs=1, device=None):
        return cls(seats=torch.zeros((n_envs,), dtype=torch.int32,
                                     device=resolve_device(device)))

    @property
    def device(self):
        return self.seats.device

    @property
    def n_envs(self):
        return self.seats.shape[0]

    @property
    def n_seats(self):
        return 2

    @property
    def obs_space(self):
        return Tensor((1,))

    @property
    def action_space(self):
        return Masked(1)

    @property
    def valid(self):
        return _ones((self.n_envs, 1), torch.bool, self.seats)

    @property
    def obs(self):
        return torch.zeros((self.n_envs, 1), device=self.device)

    @property
    def logits(self):
        return uniform_logits(self.valid)

    @property
    def v(self):
        # +1 for seat 0, -1 for seat 1, whoever is to move
        ones = torch.ones_like(self.seats, dtype=torch.float32)
        return torch.stack([ones, -ones], -1)

    def step(self, actions):
        terminal = self.seats == 1
        t = terminal.to(torch.float32)
        return (replace(self, seats=1 - self.seats),
                Transition(terminal, torch.stack([t, -t], -1)))


@dataclass
class All:
    """Each seat must submit action 1 on every turn for `length` turns; an
    all-ones history scores +1 per seat, anything else 0. The root value is
    2^-length for each seat."""

    history: torch.Tensor  # (B, length, n_seats) int32 in {-1, 0, 1}
    count: torch.Tensor  # (B,) int32 plies played this episode

    @classmethod
    def initial(cls, n_envs=1, n_seats=1, length=4, device=None):
        device = resolve_device(device)
        return cls(
            history=torch.full((n_envs, length, n_seats), -1, dtype=torch.int32, device=device),
            count=torch.zeros((n_envs,), dtype=torch.int32, device=device),
        )

    @property
    def device(self):
        return self.count.device

    @property
    def n_envs(self):
        return self.history.shape[0]

    @property
    def length(self):
        return self.history.shape[1]

    @property
    def n_seats(self):
        return self.history.shape[2]

    @property
    def max_count(self):
        return self.length * self.n_seats

    @property
    def obs_space(self):
        return Tensor((1,))

    @property
    def action_space(self):
        return Masked(2)

    @property
    def valid(self):
        return _ones((self.n_envs, 2), torch.bool, self.count)

    @property
    def seats(self):
        return (self.count % self.n_seats).to(torch.int32)

    @property
    def obs(self):
        return (self.count[:, None] / self.max_count).to(torch.float32)

    @property
    def logits(self):
        return uniform_logits(self.valid)

    @property
    def v(self):
        ones = (self.history == 1).sum(-2)  # (B, n_seats)
        correct_so_far = ones == self.count[:, None]
        correct_to_go = torch.pow(2.0, (ones - self.length).to(torch.float32))
        return correct_so_far * correct_to_go

    def step(self, actions):
        envs = torch.arange(self.n_envs, device=self.device)
        idx = torch.div(self.count, self.n_seats, rounding_mode="floor").long()
        history = self.history.clone()
        history[envs, idx, self.seats.long()] = actions.to(torch.int32)
        count = self.count + 1

        terminal = count == self.max_count
        rewards = (terminal[:, None] & (history == 1).all(-2)).to(torch.float32)

        count = torch.where(terminal, 0, count)
        history = torch.where(terminal[:, None, None], -1, history)
        return replace(self, history=history, count=count), Transition(terminal, rewards)


@dataclass
class SequentialMatrix:
    """A two-seat one-shot 2x2 matrix game played in turn: seat 0 moves,
    then seat 1, then both are paid from the (a0, a1) cell."""

    payoffs: torch.Tensor  # (B, 2, 2, 2) f32
    moves: torch.Tensor  # (B, 2) int32, -1 until played
    seats: torch.Tensor  # (B,) int32

    @classmethod
    def initial(cls, payoff, n_envs=1, device=None):
        device = resolve_device(device)
        payoff = torch.as_tensor(payoff, dtype=torch.float32, device=device)
        return cls(
            payoffs=payoff[None].expand((n_envs,) + payoff.shape).contiguous(),
            moves=torch.full((n_envs, 2), -1, dtype=torch.int32, device=device),
            seats=torch.zeros((n_envs,), dtype=torch.int32, device=device),
        )

    @classmethod
    def dilemma(cls, n_envs=1, device=None):
        return cls.initial([[[0.0, 0.0], [1.0, 0.0]], [[0.0, 1.0], [0.5, 0.5]]], n_envs, device)

    @classmethod
    def antisymmetric(cls, n_envs=1, device=None):
        return cls.initial([[[1.0, 0.0], [1.0, 1.0]], [[0.0, 0.0], [0.0, 0.1]]], n_envs, device)

    @property
    def device(self):
        return self.seats.device

    @property
    def n_envs(self):
        return self.seats.shape[0]

    @property
    def n_seats(self):
        return 2

    @property
    def obs_space(self):
        return Tensor((1,))

    @property
    def action_space(self):
        return Masked(2)

    @property
    def obs(self):
        return self.moves[:, [0]].to(torch.float32)

    @property
    def valid(self):
        return _ones((self.n_envs, 2), torch.bool, self.seats)

    @property
    def logits(self):
        return uniform_logits(self.valid)

    @property
    def v(self):
        return torch.zeros((self.n_envs, 2), device=self.device)

    def step(self, actions):
        envs = torch.arange(self.n_envs, device=self.device)
        seats = self.seats + 1
        terminal = seats == 2

        moves = self.moves.clone()
        moves[envs, self.seats.long()] = actions.to(torch.int32)
        picked = self.payoffs[envs, moves[:, 0].clamp_min(0).long(),
                              moves[:, 1].clamp_min(0).long()]
        rewards = torch.where(terminal[:, None], picked, 0.0)

        seats = torch.where(terminal, 0, seats)
        moves = torch.where(terminal[:, None], -1, moves)
        return replace(self, moves=moves, seats=seats), Transition(terminal, rewards)
