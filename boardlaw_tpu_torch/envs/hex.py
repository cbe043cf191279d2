"""Vectorized Hex. Counterpart of boardlaw_tpu/envs/hex.py.

The board stores edge-connectivity labels: cells are one of EMPTY, BLACK,
WHITE, TOP, BOT, LEFT, RIGHT, where TOP/BOT mark black groups connected to the
top/bottom edge and LEFT/RIGHT white groups connected to the left/right edge.
A move inspects its six neighbours to detect a win and relabels the
just-placed group with a masked dilation (the flood).

`Hex.step` takes one of two routes by the board's device: on the card, the
`hex_step` CUDA kernel (`mcts/kernels.py`, `csrc/hex_step.cu`) steps each
board in one launch, its flood run to its fixpoint on the device; on the
CPU, `step_reference`, the kernel's twin and specification, runs plain
PyTorch ops and the batched flood `_flood`.

Boards are uint8 (B,S,S); observations are channels-last (B,S,S,2), as in
the JAX package. White plays and observes in the transposed frame.

`Solitaire` is one-player Hex: after each move an opponent `_play`s until
the protagonist (black) is to move again; `Lazy`'s opponent takes the first
valid cell, `Random`'s a uniform valid one, drawn through `Draws`.
`from_string` builds a one-env world from an ASCII board; `color_board`,
`plot_board` and `plot_worlds` draw boards (they import matplotlib where
they are called).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from .base import Masked, Tensor, Transition
from ..utils import resolve_device
from ..utils.profiling import count, span

# spans and counters (utils.profiling)
STEP = "hex.step"
FLOOD = "hex.flood"
SYNC_FLOOD = "sync.hex.flood"
SYNC_OBS = "sync.hex.obs"

EMPTY, BLACK, WHITE, TOP, BOT, LEFT, RIGHT = range(7)

CHARS = ".bwTBLR"
ORDS = {c: i for i, c in enumerate(CHARS)}

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


@span(FLOOD)
def _flood(board, pos, stone, new_val):
    """Relabel the same-coloured group containing the one-hot cell `pos` with
    `new_val` wherever `new_val` is an edge label (>= TOP). The group is
    the cells holding exactly `stone`: labelled cells block the flood.

    The JAX package runs this as a `lax.while_loop` on a global "grew" flag;
    here the flag is checked on the host, once per 4 dilations as there:
    each check is a wait for the device (`SYNC_FLOOD`). Only the twin's
    route, on the CPU, runs it: on the card the `hex_step` kernel floods
    each board to its fixpoint on the device and `SYNC_FLOOD` stays 0."""
    own = board == stone[:, None, None]
    active = (new_val >= TOP)[:, None, None]
    frontier = pos & active
    count(SYNC_FLOOD)
    if bool(frontier.any()):
        while True:
            nxt = frontier
            for _ in range(4):
                nxt = _dilate(nxt) & own
            count(SYNC_FLOOD)
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


def step_reference(board, seats, actions, reset=True):
    """`Hex.step` on tensors, the `hex_step` kernel's plain twin: flat
    actions in the acting player's frame -> (board, seats, rewards (B,2)
    f32, terminal (B,) bool); with `reset`, won boards are cleared and give
    black the move."""
    new_board, rewards = _step_boards(board, seats, actions)
    if reset:
        terminal = (rewards > 0).any(-1)
    else:
        terminal = torch.zeros((board.shape[0],), dtype=torch.bool, device=board.device)
    new_board = torch.where(terminal[:, None, None], EMPTY, new_board).to(torch.uint8)
    new_seats = torch.where(terminal, 0, 1 - seats).to(seats.dtype)
    return new_board, new_seats, rewards, terminal


def _observe(board, seats):
    """(B,S,S,2) f32 one-hot planes in the current player's frame: plane 0
    own stones, plane 1 the opponent's. White sees the transposed board.
    The colour map is copied from pageable host memory, which on a card
    waits for the device (`SYNC_OBS`)."""
    count(SYNC_OBS)
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

    @span(STEP)
    def step(self, actions, reset=True):
        """Step every env with a flat action in the acting player's frame,
        or with (n_envs, 2) row/col pairs, flattened to row * S + col.
        Terminal envs are auto-reset: board cleared, black to move, flagged
        in the returned Transition. A board on the card takes the `hex_step`
        kernel, one on the CPU its twin `step_reference`."""
        if actions.dim() == 2:
            actions = actions[:, 0] * self.boardsize + actions[:, 1]
        if self.board.is_cuda:
            from ..mcts import kernels  # at call time: envs/ loads no search at import

            board, seats, rewards, terminal = kernels.hex_step(
                self.board.contiguous(), self.seats.contiguous(), actions.contiguous(), reset)
        else:
            board, seats, rewards, terminal = step_reference(self.board, self.seats, actions,
                                                             reset)
        return replace(self, board=board, seats=seats), Transition(terminal, rewards)

    def render(self, e=0):
        """ASCII board: '.' empty, 'b/w' stones, 'T/B/L/R' edge-labelled."""
        return "\n".join("".join(CHARS[v] for v in row) for row in self.board[e].tolist())


def _where(mask, a, b):
    """Field-wise `torch.where` of two worlds of one class: env e of the
    result is env e of `a` where mask[e], else of `b`."""
    def pick(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return replace(b, **{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                         for f in fields(b)})


class Solitaire(Hex):
    """One-player Hex: the opponent (white) is auto-played by `_play` after
    every move that does not end the game, so black is always to move.
    Rewards are the protagonist's, (n_envs, 1)."""

    @classmethod
    def initial(cls, n_envs, boardsize=11, seat=0, device=None):
        if seat == 1:
            raise ValueError("seat #1 is not supported")
        return super().initial(n_envs, boardsize, device=device)

    @property
    def n_seats(self):
        return 1

    def _play(self, world, draws):
        raise NotImplementedError

    def step(self, actions, draws=None):
        world, transition = Hex.step(self, actions)
        rewards, terminal = transition.rewards, transition.terminal
        # the opponent's turn comes up exactly when the protagonist's move
        # did not end the game (a reset hands the move back to black); it
        # is played in every env and kept where needed, as in the JAX package
        stepped, tr = self._play(world, draws)
        needs = world.seats != self.seats
        world = _where(needs, stepped, world)
        rewards = rewards + torch.where(needs[:, None], tr.rewards, 0.0)
        terminal = terminal | (needs & tr.terminal)
        envs = torch.arange(self.n_envs, device=self.device)
        my_rewards = rewards[envs, self.seats.long()][:, None]
        return world, Transition(terminal, my_rewards)


class Lazy(Solitaire):
    """The opponent plays the first valid action in its frame."""

    def _play(self, world, draws):
        valid = world.valid
        n_actions = valid.shape[1]
        idx = torch.where(valid, torch.arange(n_actions, device=valid.device)[None, :], n_actions)
        return Hex.step(world, idx.min(-1).values)


class Random(Solitaire):
    """The opponent plays a uniform random valid action: argmax(logits +
    Gumbel noise) from `draws.gumbel`, which is how `jax.random.categorical`
    draws."""

    def _play(self, world, draws):
        if draws is None:
            raise TypeError("Random.step needs draws: world.step(actions, draws=d)")
        logits = torch.where(world.valid, 0.0, -torch.inf)
        actions = torch.argmax(logits + draws.gumbel(logits.shape), -1)
        return Hex.step(world, actions)


# -- display ---------------------------------------------------------------

def color_board(board, colors="obs"):
    """RGB of each cell of an (S, S) board of labels: by stone colour
    ('obs'), or with the edge-connected groups tinted ('board')."""
    import matplotlib as mpl

    black = (0, 0, 0.4)
    white = (0, 0, 0.8)
    tan = (0.07, 0.4, 0.8)
    if colors == "obs":
        hsv = [tan, black, white, black, black, white, white]
    elif colors == "board":
        hsv = [tan, black, white, (0.16, 0.2, 0.4), (0.33, 0.2, 0.4), (0.66, 0.2, 0.8),
               (0.72, 0.2, 0.8)]
    else:
        raise ValueError(colors)
    rgb = np.stack([mpl.colors.hsv_to_rgb(c) for c in hsv])
    return rgb[np.asarray(board)]


def plot_board(colors, ax=None):
    """Draw a hex board from an (S, S, 3) colour array: hexagon patches on
    offset rows. Returns the axes."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    ax = plt.subplots()[1] if ax is None else ax
    ax.set_aspect(1)
    S = colors.shape[0]
    sin60 = np.sin(np.pi / 3)
    radius = 0.5 / sin60
    for r in range(S):
        for c in range(S):
            ax.add_patch(mpl.patches.RegularPolygon(
                (c + 0.5 * r, sin60 * (S - 1 - r)), numVertices=6, radius=radius,
                facecolor=colors[r, c], edgecolor="k", linewidth=1))
    ax.set_xlim(-1, 1.5 * S)
    ax.set_ylim(-1, sin60 * S + 1)
    ax.set_frame_on(False)
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def plot_worlds(world, e=0, ax=None, colors="obs"):
    return plot_board(color_board(world.board[e].cpu().numpy(), colors), ax=ax)


# -- test and analysis helpers -----------------------------------------------

def board_size(s):
    return len(_strip(s).splitlines())


def _strip(s):
    return "\n".join(line.strip() for line in s.splitlines() if line.strip())


def board_actions(s):
    """The alternating black/white (row, col) actions (n, 2) int32 that
    build an ASCII board of 'b'/'w'/'.' cells. White's actions are in
    white's (transposed) frame."""
    grid = np.array([list(line) for line in _strip(s).splitlines()])
    bs = np.argwhere(grid == "b")
    ws = np.argwhere(grid == "w")
    if len(bs) - len(ws) not in (0, 1):
        raise ValueError(f"a board to replay has as many black stones as white ones or one "
                         f"more, got {len(bs)} and {len(ws)}")

    actions = []
    for i in range(len(ws)):
        actions.append([bs[i, 0], bs[i, 1]])
        actions.append([ws[i, 1], ws[i, 0]])
    if len(ws) < len(bs):
        actions.append([bs[-1, 0], bs[-1, 1]])
    return np.array(actions, dtype=np.int32).reshape(-1, 2)


def from_string(s, device=None):
    """A one-env world built by replaying the moves of an ASCII board."""
    world = Hex.initial(n_envs=1, boardsize=board_size(s), device=device)
    for a in board_actions(s):
        world, _ = world.step(torch.as_tensor(a, device=world.device)[None])
    return world
