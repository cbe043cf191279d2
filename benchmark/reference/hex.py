"""Plain vectorized Hex: the rules the program's env implements, written
out again for the check.

A board is (B,S,S) uint8 cell labels: EMPTY, BLACK, WHITE, or the label of
a group that touches an edge (TOP/BOT for black, LEFT/RIGHT for white).
Black (seat 0) joins top to bottom and moves first; white joins left to
right and plays and observes in the transposed frame. A stone wins when its
neighbours touch both of its edges, and a won game is reset. A stone that
touches one of its edges gives that edge's label to the plain stones of its
colour that it joins.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

EMPTY, BLACK, WHITE, TOP, BOT, LEFT, RIGHT = range(7)
NEIGHBOURS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))
# colour of a label: 0 black, 1 white, 2 empty
COLOUR = (2, 0, 1, 0, 0, 1, 1)


def _shifted(padded, S):
    """The six neighbour views of a board padded by one cell each side."""
    return [padded[:, 1 + dr:1 + dr + S, 1 + dc:1 + dc + S] for dr, dc in NEIGHBOURS]


def _edges(board):
    """The board inside a ring of edge labels; the top and bottom rows take
    the corners."""
    B, S, _ = board.shape
    p = torch.zeros((B, S + 2, S + 2), dtype=torch.int64, device=board.device)
    p[:, 1:-1, 1:-1] = board
    p[:, :, 0] = LEFT
    p[:, :, -1] = RIGHT
    p[:, 0, :] = TOP
    p[:, -1, :] = BOT
    return p


def _grow(mask):
    """The cells of `mask` and their six neighbours."""
    B, S, _ = mask.shape
    p = torch.zeros((B, S + 2, S + 2), dtype=torch.bool, device=mask.device)
    p[:, 1:-1, 1:-1] = mask
    out = mask.clone()
    for dr, dc in NEIGHBOURS:
        out |= p[:, 1 - dr:1 - dr + S, 1 - dc:1 - dc + S]
    return out


def step(board, seats, actions):
    """One move in every env. -> (board, seats, terminal (B,) bool,
    rewards (B,2) f32)."""
    B, S, _ = board.shape
    dev = board.device
    a = actions.long()
    black = seats == 0
    row = torch.where(black, a // S, a % S)
    col = torch.where(black, a % S, a // S)
    cells = torch.arange(S, device=dev)
    at = (cells[None, :, None] == row[:, None, None]) & (cells[None, None, :] == col[:, None, None])

    near = torch.stack([torch.where(at, n, 0).sum((1, 2)) for n in _shifted(_edges(board), S)], -1)
    touch = {lab: (near == lab).any(-1) for lab in (TOP, BOT, LEFT, RIGHT)}
    win = torch.where(black, touch[TOP] & touch[BOT], touch[LEFT] & touch[RIGHT])
    r0 = torch.where(black, 1.0, -1.0) * win
    rewards = torch.stack([r0, -r0], -1).float()

    stone = torch.where(black, BLACK, WHITE).to(torch.uint8)
    label = torch.where(black, torch.where(touch[TOP], TOP, torch.where(touch[BOT], BOT, BLACK)),
                        torch.where(touch[LEFT], LEFT, torch.where(touch[RIGHT], RIGHT, WHITE)))
    placed = torch.where(at, stone[:, None, None], board)

    # the plain stones of the mover's colour that the new stone joins
    own = placed == stone[:, None, None]
    group = at & (label >= TOP)[:, None, None]
    while True:
        nxt = _grow(group) & own
        if torch.equal(nxt, group):
            break
        group = nxt
    placed = torch.where(group, label[:, None, None].to(torch.uint8), placed)

    board = torch.where(win[:, None, None], torch.zeros_like(placed), placed)
    seats = torch.where(win, 0, 1 - seats).to(seats.dtype)
    return board, seats, win, rewards


def valid(board, seats):
    """(B, S*S) bool: the empty cells, in the mover's frame."""
    empty = board == EMPTY
    empty = torch.where((seats == 1)[:, None, None], empty.transpose(1, 2), empty)
    return empty.reshape(board.shape[0], -1)


def observe(board, seats):
    """(B,S,S,2) f32: the mover's stones, then the opponent's, in the
    mover's frame."""
    colour = torch.tensor(COLOUR, device=board.device)[board.long()]
    white = (seats == 1)[:, None, None]
    colour = torch.where(white, colour.transpose(1, 2), colour)
    mine = torch.where(white, colour == 1, colour == 0)
    theirs = torch.where(white, colour == 0, colour == 1)
    return torch.stack([mine, theirs], -1).float()


@lru_cache
def _neighbour_table(S):
    """(S*S, 6) flat index of each cell's neighbours, S*S off the board."""
    out = np.full((S * S, 6), S * S)
    for r in range(S):
        for c in range(S):
            for k, (dr, dc) in enumerate(NEIGHBOURS):
                if 0 <= r + dr < S and 0 <= c + dc < S:
                    out[r * S + c, k] = (r + dr) * S + c + dc
    return out


def step_host(board, seats, actions):
    """`step` over numpy arrays, for many moves of a few envs on the host:
    the neighbours read by index, the flood run to its end."""
    B, S, _ = board.shape
    black = seats == 0
    row = np.where(black, actions // S, actions % S)
    col = np.where(black, actions % S, actions // S)
    p = np.zeros((B, S + 2, S + 2), dtype=np.int64)
    p[:, 1:-1, 1:-1] = board
    p[:, :, 0], p[:, :, -1], p[:, 0, :], p[:, -1, :] = LEFT, RIGHT, TOP, BOT
    e = np.arange(B)
    near = np.stack([p[e, row + 1 + dr, col + 1 + dc] for dr, dc in NEIGHBOURS], -1)
    touch = {lab: (near == lab).any(-1) for lab in (TOP, BOT, LEFT, RIGHT)}
    win = np.where(black, touch[TOP] & touch[BOT], touch[LEFT] & touch[RIGHT])
    r0 = np.where(black, 1.0, -1.0) * win
    stone = np.where(black, BLACK, WHITE).astype(np.uint8)
    label = np.where(black, np.where(touch[TOP], TOP, np.where(touch[BOT], BOT, BLACK)),
                     np.where(touch[LEFT], LEFT, np.where(touch[RIGHT], RIGHT, WHITE)))
    placed = board.reshape(B, S * S).copy()
    at = row * S + col
    placed[e, at] = stone
    flood = np.flatnonzero(label >= TOP)
    if len(flood):
        table = _neighbour_table(S)
        own = np.pad(placed[flood] == stone[flood, None], ((0, 0), (0, 1)))
        group = np.zeros_like(own)
        group[np.arange(len(flood)), at[flood]] = True
        while True:
            grown = group.copy()
            grown[:, :-1] |= group[:, table].any(-1)
            grown &= own
            if (grown == group).all():
                break
            group = grown
        sub = placed[flood]
        placed[flood] = np.where(group[:, :-1], label[flood, None].astype(np.uint8), sub)
    board = np.where(win[:, None], np.uint8(EMPTY), placed).reshape(B, S, S)
    seats = np.where(win, 0, 1 - seats).astype(seats.dtype)
    return board, seats, win, np.stack([r0, -r0], -1).astype(np.float32)
