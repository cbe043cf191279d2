"""Vectorized Hex. Counterpart of boardlaw_tpu/envs/hex.py.

The board stores edge-connectivity labels: cells are one of EMPTY, BLACK,
WHITE, TOP, BOT, LEFT, RIGHT, where TOP/BOT mark black groups connected to the
top/bottom edge and LEFT/RIGHT white groups connected to the left/right edge.
A move inspects its six neighbours to detect a win and relabels the
just-placed group with a batched masked dilation (the flood).

Boards are uint8 (B,S,S); observations are channels-last (B,S,S,2), as in
the JAX package. White plays and observes in the transposed frame.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .base import Masked, Tensor, Transition
from ..utils import resolve_device

EMPTY, BLACK, WHITE, TOP, BOT, LEFT, RIGHT = range(7)

# The six hex-grid neighbour offsets (row, col).
NEIGHBOURS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))

# Colour of each cell label: 0 black (BLACK/TOP/BOT), 1 white, 2 empty.
_COLORMAP = (2, 0, 1, 0, 0, 1, 1)


def _pad1(x, value=0):
    """Pad the two trailing axes of a (B,S,S) tensor by one cell each side."""
    B, S, _ = x.shape
    p = torch.full((B, S + 2, S + 2), value, dtype=x.dtype, device=x.device)
    p[:, 1:-1, 1:-1] = x
    return p


def _padded_with_edges(board):
    """Board padded by one ring of virtual edge labels: the top/bottom rows
    are TOP/BOT over the full padded width (they take precedence at the
    corners), the side columns LEFT/RIGHT."""
    p = _pad1(board)
    p[:, :, 0] = LEFT
    p[:, :, -1] = RIGHT
    p[:, 0, :] = TOP
    p[:, -1, :] = BOT
    return p


def _neighbour_values(board, pos):
    """Values of the 6 neighbours of the one-hot cell `pos` per env, with
    virtual edge labels off the board. board (B,S,S) uint8, pos (B,S,S) bool
    -> (B,6) int32."""
    S = board.shape[-1]
    p = _padded_with_edges(board).to(torch.int32)
    vals = []
    for dr, dc in NEIGHBOURS:
        shifted = p[:, 1 + dr: 1 + dr + S, 1 + dc: 1 + dc + S]
        vals.append(torch.where(pos, shifted, 0).sum((1, 2)))
    return torch.stack(vals, -1)


def _dilate(frontier):
    """One step of 6-neighbour hex dilation of a (B,S,S) boolean mask."""
    p = _pad1(frontier, False)
    H, W = p.shape[1], p.shape[2]
    out = frontier
    for dr, dc in NEIGHBOURS:
        out = out | p[:, 1 - dr: H - 1 - dr, 1 - dc: W - 1 - dc]
    return out


def _flood(board, pos, stone, new_val):
    """Relabel the same-coloured group containing the one-hot cell `pos` with
    `new_val` wherever `new_val` is an edge label (>= TOP).

    The JAX package runs this as a `lax.while_loop` on a global "grew" flag;
    here the flag is checked on the host, once per 4 dilations as there."""
    own = board == stone[:, None, None]
    active = (new_val >= TOP)[:, None, None]
    frontier = pos & active
    if bool(frontier.any()):
        while True:
            nxt = frontier
            for _ in range(4):
                nxt = _dilate(nxt) & own
            grew = bool((nxt != frontier).any())
            frontier = nxt
            if not grew:
                break
    return torch.where(frontier & active, new_val[:, None, None].to(board.dtype), board)


def _step_boards(board, seats, actions):
    """Place a stone, detect wins, flood edge labels. Actions are flat
    indices in the acting player's frame. -> (new_board, rewards (B,2) f32)."""
    S = board.shape[-1]
    seats = seats.to(torch.int32)
    actions = actions.to(torch.int32)

    black = seats == 0
    row = torch.where(black, torch.div(actions, S, rounding_mode="floor"),
                      torch.remainder(actions, S))
    col = torch.where(black, torch.remainder(actions, S),
                      torch.div(actions, S, rounding_mode="floor"))

    iota = torch.arange(S, device=board.device)
    pos = (iota[None, :, None] == row[:, None, None]) & (iota[None, None, :] == col[:, None, None])

    nv = _neighbour_values(board, pos)
    adj_top = (nv == TOP).any(-1)
    adj_bot = (nv == BOT).any(-1)
    adj_left = (nv == LEFT).any(-1)
    adj_right = (nv == RIGHT).any(-1)

    win = torch.where(black, adj_top & adj_bot, adj_left & adj_right)
    black_reward = torch.where(black, 1.0, -1.0) * win
    rewards = torch.stack([black_reward, -black_reward], -1).to(torch.float32)

    new_val = torch.where(
        black,
        torch.where(adj_top, TOP, torch.where(adj_bot, BOT, BLACK)),
        torch.where(adj_left, LEFT, torch.where(adj_right, RIGHT, WHITE)),
    ).to(board.dtype)

    stone = torch.where(black, BLACK, WHITE).to(board.dtype)
    board = torch.where(pos, stone[:, None, None], board)
    board = _flood(board, pos, stone, new_val)
    return board, rewards


def _observe(board, seats):
    """(B,S,S,2) f32 one-hot planes in the current player's frame: plane 0
    own stones, plane 1 the opponent's. White sees the transposed board."""
    cmap = torch.tensor(_COLORMAP, dtype=torch.uint8, device=board.device)
    colors = cmap[board.long()]
    flip = (seats == 1)[:, None, None]
    sel = torch.where(flip, colors.transpose(-1, -2), colors)
    own = torch.where(flip, sel == 1, sel == 0)
    opp = torch.where(flip, sel == 0, sel == 1)
    return torch.stack([own, opp], -1).to(torch.float32)


@dataclass
class Hex:
    """Two-player Hex. Black (seat 0) connects top-bottom and moves first;
    white (seat 1) connects left-right."""

    board: torch.Tensor  # (n_envs, S, S) uint8 cell labels
    seats: torch.Tensor  # (n_envs,) int32 seat to play

    @classmethod
    def initial(cls, n_envs, boardsize=11, device=None):
        device = resolve_device(device)
        return cls(
            board=torch.zeros((n_envs, boardsize, boardsize), dtype=torch.uint8, device=device),
            seats=torch.zeros((n_envs,), dtype=torch.int32, device=device),
        )

    @property
    def device(self):
        return self.board.device

    @property
    def n_envs(self):
        return self.board.shape[0]

    @property
    def boardsize(self):
        return self.board.shape[-1]

    @property
    def n_seats(self):
        return 2

    @property
    def obs_space(self):
        return Tensor((self.boardsize, self.boardsize, 2))

    @property
    def action_space(self):
        return Masked(self.boardsize * self.boardsize)

    @property
    def obs(self):
        return _observe(self.board, self.seats)

    @property
    def valid(self):
        empty = self.board == EMPTY
        flip = (self.seats == 1)[:, None, None]
        sel = torch.where(flip, empty.transpose(-1, -2), empty)
        return sel.reshape(self.n_envs, -1)

    def step(self, actions, reset=True):
        """Step every env with a flat action in the acting player's frame.
        Terminal envs are auto-reset: board cleared, black to move, flagged
        in the returned Transition."""
        new_board, rewards = _step_boards(self.board, self.seats, actions)
        if reset:
            terminal = (rewards > 0).any(-1)
        else:
            terminal = torch.zeros((self.n_envs,), dtype=torch.bool, device=self.device)
        new_board = torch.where(terminal[:, None, None], EMPTY, new_board).to(torch.uint8)
        new_seats = torch.where(terminal, 0, 1 - self.seats).to(self.seats.dtype)
        return replace(self, board=new_board, seats=new_seats), Transition(terminal, rewards)
