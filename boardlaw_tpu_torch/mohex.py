"""MoHex reference opponent, driven over GTP pipes. Counterpart of
boardlaw_tpu/mohex.py, host-side and off the training path.

A config file of `param_mohex ...` settings, a GTP conversation
(`boardsize`, `loadsgf`, `play`, `reg_genmove`) over the subprocess's
stdin/stdout, board states shipped as SGF, and a batched `MoHexAgent`
multiplexing up to `max_proxies` engine processes with optional
random-move blending. If no MoHex binary is on PATH, `available()` is
False; the bundled engine (`gtp_engine.command()`) speaks the same GTP.
The agent follows the port's protocol `agent(world, draws=None,
eval=False)`: its random blend takes its seed from `draws.integer`, where
the JAX package draws it from its key.
"""
from __future__ import annotations

import os
import shlex
import shutil
import subprocess
from logging import getLogger
from select import select
from tempfile import NamedTemporaryFile

import numpy as np
import torch

log = getLogger(__name__)

BINARY = os.environ.get("MOHEX_BINARY", "mohex")


def available():
    return shutil.which(shlex.split(BINARY)[0]) is not None


def configfile(max_games=None, max_memory=None, presearch=None, max_time=None,
               max_nodes=None, solver=True, extras=()):
    """Write a MoHex parameter file; returns its path."""
    contents = []
    if max_games is not None:
        contents.append(f"param_mohex max_games {max_games}")
        if max_games < 11:
            # With very few games the expand threshold must drop too, else the
            # search never updates the table and a random move comes back.
            contents.append(f"param_mohex expand_threshold {max_games - 1}")
    if solver:
        contents.extend([
            "param_mohex knowledge_threshold 0",
            "param_mohex use_parallel_solver 1",
            "param_dfpn threads 4",
        ])
    if presearch is not None:
        contents.append(f"param_mohex perform_pre_search {int(presearch)}")
    if max_memory is not None:
        contents.append(f"param_mohex max_memory {int(max_memory * 1e6)}")
    if max_nodes is not None:
        contents.append(f"param_mohex max_nodes {int(max_nodes)}")
    if max_time is not None:
        contents.append("param_mohex use_time_management 1")
        contents.append(f"param_game game_time {max_time / 2}")
    contents.extend(extras)

    with NamedTemporaryFile("w", delete=False, prefix="mohex-config-") as f:
        f.write("\n".join(contents))
    return f.name


def to_notation(pos):
    row, col = pos
    return f"{chr(ord('a') + int(col))}{int(row) + 1}"


def from_notation(resp):
    col, row = resp[:1], resp[1:]
    return int(row) - 1, ord(col) - ord("a")


def as_sgf(obs, seat):
    """Serialize an (S,S,2) observation (numpy) to SGF in black's frame."""
    obs = np.asarray(obs)
    size = obs.shape[0]
    assert obs.ndim == 3, "observations must be (S, S, 2) piece indicators"
    assert size <= 13, "MoHex only supports up to 13x13 boards"
    if seat == 1:
        obs = obs.transpose(1, 0, 2)[..., ::-1]

    moves = []
    for colour, plane in zip("BW", (obs[..., 0], obs[..., 1])):
        for pos in np.argwhere(plane):
            moves.append(f"{colour}[{to_notation(pos)}]")
    return f"(;AP[HexGui:0.2]FF[4]GM[11]SZ[{size}];{';'.join(moves)})"


class GTP:
    """A GTP conversation with a subprocess."""

    def __init__(self, command):
        self._p = subprocess.Popen(shlex.split(command), stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        log.debug(f"# {command}")

    def _log_stderr(self):
        for s in select([self._p.stderr], [], [], 0)[0]:
            chunk = os.read(s.fileno(), 8192).decode()
            for line in chunk.splitlines():
                log.debug(line)

    def answer(self):
        self._log_stderr()
        lines = []
        while True:
            line = self._p.stdout.readline()
            if line == "":
                self._log_stderr()
                raise IOError("GTP subprocess returned an empty line")
            log.debug(f"<{line.strip()}")
            if line == "\n":
                break
            lines.append(line)
        answer = "".join(lines)
        if not answer or answer[0] != "=":
            raise ValueError(answer[2:].strip())
        if len(lines) == 1:
            return answer[1:].strip()
        return answer[2:]

    def send(self, cmd):
        log.debug(f">{cmd}")
        self._p.stdin.write(f"{cmd}\n")
        self._p.stdin.flush()
        return self.answer

    def query(self, cmd):
        return self.send(cmd)()

    def close(self):
        """Stop the subprocess and reap it."""
        try:
            self._p.terminate()
            self._p.wait(timeout=10)
        except Exception:
            pass


class MoHex(GTP):
    def __init__(self, command=None, **kwargs):
        if command is None:
            command = f"{BINARY} --use-logfile=0 --config={configfile(**kwargs)}"
        super().__init__(command)

    def boardsize(self, size):
        self.query(f"boardsize {size}")

    def clear(self):
        self.query("clear_board")

    def play(self, color, pos):
        self.query(f"play {color} {to_notation(pos)}")

    def load(self, obs, seat):
        with NamedTemporaryFile("w") as f:
            f.write(as_sgf(obs, seat))
            f.flush()
            self.query(f"loadsgf {f.name}")

    def solve_async(self, color):
        f = self.send(f"reg_genmove {color}")

        def future():
            return from_notation(f().strip())

        return future

    def solve(self, color):
        return self.solve_async(color)()

    def display(self):
        s = self.query("showboard")
        print("\n".join(s.splitlines()[3:-1]))


class MoHexAgent:
    """An agent over a pool of MoHex processes, with `random` in [0, 1]
    blending uniform-random moves in (the calibration ladder's dial)."""

    def __init__(self, random=0.0, max_proxies=8, command=None, **kwargs):
        self._proxies = []
        self._command = command
        self._kwargs = kwargs
        self.random = random
        self.max_proxies = max_proxies

    def _ensure(self, n):
        while len(self._proxies) < min(n, self.max_proxies):
            self._proxies.append(MoHex(command=self._command, **self._kwargs))

    def _chunk(self, obs, seats, valid, boardsize, rng):
        n = len(seats)
        actions = np.array([rng.choice(np.flatnonzero(valid[e])) for e in range(n)])
        use_mohex = rng.random(n) >= self.random
        if use_mohex.any():
            self._ensure(n)

        futures = {}
        for e in range(n):
            if not use_mohex[e]:
                continue
            self._proxies[e].load(obs[e], seats[e])
            futures[e] = self._proxies[e].solve_async("bw"[seats[e]])

        for e, future in futures.items():
            if seats[e] == 0:
                row, col = future()
            else:
                col, row = future()
            actions[e] = boardsize * row + col
        return actions

    def __call__(self, world, draws=None, eval=False):
        obs = world.obs.cpu().numpy()
        seats = world.seats.cpu().numpy()
        valid = world.valid.cpu().numpy()
        rng = np.random.default_rng(draws.integer(2 ** 31 - 1) if draws is not None else 0)

        actions = np.zeros(world.n_envs, int)
        for i in range(0, world.n_envs, self.max_proxies):
            s = slice(i, min(i + self.max_proxies, world.n_envs))
            actions[s] = self._chunk(obs[s], seats[s], valid[s], world.boardsize, rng)
        return {"actions": torch.as_tensor(actions, dtype=torch.int32, device=world.device)}

    def close(self):
        for p in self._proxies:
            p.close()
        self._proxies = []
