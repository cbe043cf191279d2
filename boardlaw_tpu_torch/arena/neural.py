"""League evaluation: all pairs of a league play at once over one env array.
Counterpart of boardlaw_tpu/arena/neural.py.

A `Tracker` keeps the games each matchup still needs and maps each env to a
live matchup; a `ChunkEvaluator` steps the shared env array with one chosen
agent at a time, collecting results as games finish. A league's results are
`Trials`: numpy columns (black_agent, white_agent, black_wins, white_wins),
what the Elo solvers read on the card's machine, which has no pandas;
`Trials.frame()` gives the JAX package's DataFrame where pandas is present.

`evaluate_parallel` farms a league's chunk jobs (`evaluate_gen`) out over
a worker pool (`utils.parallel`, by default two workers pinned to the
cards) and merges their `Trials`.
"""
from __future__ import annotations

import time
from functools import partial
from logging import getLogger

import numpy as np
import torch

from ..draws import Draws
from ..envs import hex
from ..mcts.search import MCTSConfig, tree_dtypes, tree_size
from ..utils import resolve_device
from ..utils.profiling import count, span

log = getLogger(__name__)

# spans and counters (utils.profiling): a league ply and its parts
STEP = "league.step"
TRACKER = "league.tracker"
SEARCH = "league.search"
ENV = "league.env"
SYNC = "league.sync"
SYNC_SEATS = "sync.league.seats"
SYNC_RESULTS = "sync.league.results"
SYNC_MASK = "sync.league.mask"

COLUMNS = ("black_agent", "white_agent", "black_wins", "white_wins")


class Trials:
    """Trial rows as four numpy columns, named as the JAX package's
    DataFrame columns: names (str) of black and white, and their wins."""

    def __init__(self, rows=()):
        rows = list(rows)
        self.black_agent = np.array([str(r[0]) for r in rows], dtype=object)
        self.white_agent = np.array([str(r[1]) for r in rows], dtype=object)
        self.black_wins = np.array([float(r[2]) for r in rows])
        self.white_wins = np.array([float(r[3]) for r in rows])

    def __len__(self):
        return len(self.black_wins)

    def rows(self):
        return [(str(b), str(w), float(x), float(y)) for b, w, x, y in
                zip(self.black_agent, self.white_agent, self.black_wins, self.white_wins)]

    def frame(self):
        """The rows as the JAX package's DataFrame (needs pandas)."""
        import pandas as pd

        return pd.DataFrame({c: getattr(self, c) for c in COLUMNS}, columns=list(COLUMNS))


class Tracker:
    """Which envs play which (black, white) matchup, and how many games
    each matchup still needs."""

    def __init__(self, n_envs, matchups, n_envs_per):
        self.n_envs = n_envs
        self.matchups = list(matchups)  # list of (black, white) name pairs
        self.remaining = {m: n_envs_per for m in self.matchups}
        self.live = np.full(n_envs, -1)  # env -> matchup index, -1 free

    def refill(self):
        """Assign free envs to the matchups with the most backlog. Returns the
        env indices that were (re)assigned (they need resetting)."""
        free = np.flatnonzero(self.live == -1)
        assigned = []
        for e in free:
            backlog = {
                i: self.remaining[m] - (self.live == i).sum()
                for i, m in enumerate(self.matchups)
                if self.remaining[m] > (self.live == i).sum()
            }
            if not backlog:
                break
            i = max(backlog, key=backlog.get)
            self.live[e] = i
            assigned.append(e)
        return np.array(assigned, int)

    def suggest(self, seats):
        """The (agent name, env mask) owning the most live envs' current
        seats."""
        seats = np.asarray(seats)
        owners = {}
        for e in np.flatnonzero(self.live >= 0):
            pair = self.matchups[self.live[e]]
            name = pair[seats[e]]
            owners.setdefault(name, []).append(e)
        if not owners:
            return None, np.zeros(self.n_envs, bool)
        name = max(owners, key=lambda k: len(owners[k]))
        mask = np.zeros(self.n_envs, bool)
        mask[owners[name]] = True
        return name, mask

    def finish(self, env_idxs):
        """Mark games finished; returns the matchup of each env and frees it."""
        out = []
        for e in env_idxs:
            i = self.live[e]
            if i < 0:
                continue
            m = self.matchups[i]
            self.remaining[m] = max(self.remaining[m] - 1, 0)
            self.live[e] = -1
            out.append(m)
        return out

    @property
    def finished(self):
        return all(v == 0 for v in self.remaining.values()) and (self.live == -1).all()


class ChunkEvaluator:
    """Plays every matchup of a league over one shared env array, one agent
    acting per step, on `device` (the card unless the caller asks for
    another). agents: dict name -> agent; each call takes `draws.split()`
    of the evaluator's `Draws(seed)`, where the JAX package splits its key."""

    def __init__(self, boardsize, n_envs, agents, matchups, n_envs_per, seed=0, device=None):
        self.device = resolve_device(device)
        self.agents = agents
        self.world = hex.Hex.initial(n_envs, boardsize, device=self.device)
        self.tracker = Tracker(n_envs, matchups, n_envs_per)
        self.draws = Draws(seed, self.device)
        # wins[env] per seat for the current game of each env
        self.wins = np.zeros((n_envs, 2))
        self.moves = 0
        self.games = 0
        self.start = time.time()

    @span(STEP)
    def step(self):
        """One acting step; returns the list of completed-matchup records
        ((black, white), black_win, white_win)."""
        dev = self.device
        with span(TRACKER):
            fresh = self.tracker.refill()
        if len(fresh):
            mask = np.zeros(self.tracker.n_envs, bool)
            mask[fresh] = True
            with span(SYNC):
                count(SYNC_MASK)
                fresh_mask = torch.as_tensor(mask, device=dev)
            with span(ENV):
                initial = hex.Hex.initial(self.tracker.n_envs, self.world.boardsize, device=dev)
                self.world = hex._where(fresh_mask, initial, self.world)
            self.wins[fresh] = 0

        with span(SYNC):
            count(SYNC_SEATS)
            seats = self.world.seats.cpu().numpy()
        with span(TRACKER):
            name, mask = self.tracker.suggest(seats)
        if name is None:
            return []

        with span(SEARCH):
            decisions = self.agents[name](self.world, self.draws.split(), eval=True)
        with span(ENV):
            stepped, transition = self.world.step(decisions["actions"])
        with span(SYNC):
            count(SYNC_MASK)
            acting = torch.as_tensor(mask, device=dev)
        with span(ENV):
            self.world = hex._where(acting, stepped, self.world)

        with span(SYNC):
            count(SYNC_RESULTS, 2)
            terminal = transition.terminal.cpu().numpy() & mask
            rewards = transition.rewards.cpu().numpy()
        self.moves += int(mask.sum())

        results = []
        if terminal.any():
            winners = rewards[terminal] == 1
            idxs = np.flatnonzero(terminal)
            pairs = []
            for k, e in enumerate(idxs):
                i = self.tracker.live[e]
                if i < 0:
                    continue
                pairs.append((self.tracker.matchups[i], winners[k]))
            with span(TRACKER):
                self.tracker.finish(idxs)
            for (black, white), win in pairs:
                results.append(((black, white), float(win[0]), float(win[1])))
                self.games += 1
        return results

    def play(self, progress_every=60):
        """Run to completion; returns the league's `Trials`, one row per
        matchup."""
        records = {}
        last = time.time()
        while not self.tracker.finished:
            for (black, white), bw, ww in self.step():
                rec = records.setdefault((black, white), [0.0, 0.0])
                rec[0] += bw
                rec[1] += ww
            if time.time() - last > progress_every:
                last = time.time()
                done = sum(v for v in records.values() for v in v)
                log.info(f"league: {done:.0f} games done, "
                         f"{self.moves / (time.time() - self.start):.0f} moves/s")
        return Trials((b, w, bw, ww) for (b, w), (bw, ww) in records.items())


def all_matchups(names):
    return [(b, w) for b in names for w in names if b != w]


def evaluate(boardsize, agents, n_envs_per=4, n_envs=None, seed=0, device=None):
    """Round-robin league over all ordered pairs, in one process."""
    names = list(agents)
    matchups = all_matchups(names)
    n_envs = n_envs or min(len(matchups) * n_envs_per, 1024)
    n_envs = max(n_envs - n_envs % 2, 2)
    ev = ChunkEvaluator(boardsize, n_envs, agents, matchups, n_envs_per, seed, device)
    return ev.play()


# --------------------------------------------------------------------------
# League chunk jobs
# --------------------------------------------------------------------------

def env_bytes(boardsize, n_nodes=64, leaves_per_pass=1):
    """Bytes one env's search tree holds on the card: the four (T, A) rows
    (f32 logits and w_edge, children and n_edge at the widths of
    `search.tree_dtypes`), the per-node statistics (parents, relation,
    seats, terminal, two-seat rewards, v, n and w: 41 bytes) and the
    per-node worlds (board and seat)."""
    cfg = MCTSConfig(n_nodes=n_nodes, leaves_per_pass=leaves_per_pass)
    T = tree_size(cfg)
    A = boardsize ** 2
    child, count = tree_dtypes(cfg)
    row = 4 + 4 + child.itemsize + count.itemsize
    return T * (A * row + 41 + boardsize ** 2 + 4)


def max_envs(boardsize, n_nodes=64, memory_bytes=2 * 1024**3, safety=0.5, leaves_per_pass=1):
    """The most envs (even) one evaluation job's trees fit in `safety` of
    `memory_bytes`, by `env_bytes`."""
    per_env = env_bytes(boardsize, n_nodes, leaves_per_pass)
    return max(int(memory_bytes * safety / per_env) // 2 * 2, 2)


def chunk_jobs(specs, chunk_size):
    """Split the agents x agents games matrix into diagonal chunks (round
    robin inside one group) and skew chunks (all cross pairs of two groups).
    Each job touches at most 2*chunk_size agents, bounding its memory."""
    names = list(specs)
    groups = [names[i:i + chunk_size] for i in range(0, len(names), chunk_size)]
    jobs = []
    for i, g in enumerate(groups):
        diag = all_matchups(g)
        if diag:
            jobs.append(({n: specs[n] for n in g}, diag))
        for h in groups[i + 1:]:
            skew = [(b, w) for b in g for w in h] + [(b, w) for b in h for w in g]
            jobs.append(({n: specs[n] for n in g + h}, skew))
    return jobs


def _run_chunk(args, device=None):
    """One chunk job: build the agents from their picklable specs with
    ``loader(spec, device)`` and play the chunk's matchups to completion on
    `device`. Module-level so it pickles."""
    boardsize, specs, loader, matchups, n_envs_per, n_envs, seed = args
    agents = {name: loader(spec, device) for name, spec in specs.items()}
    ev = ChunkEvaluator(boardsize, n_envs, agents, matchups, n_envs_per, seed, device)
    return ev.play()


def run_agent_loader(spec, device=None):
    """Default loader: spec = (run, snapshot index or None), loaded from run
    storage onto `device`."""
    from . import common

    run, idx = spec
    return common.agent(run, idx, device=device)


def merge(trials):
    """One `Trials` of several, the rows of each (black, white) pair
    summed."""
    rows = {}
    for t in trials:
        for b, w, bw, ww in t.rows():
            rec = rows.setdefault((b, w), [0.0, 0.0])
            rec[0] += bw
            rec[1] += ww
    return Trials((b, w, bw, ww) for (b, w), (bw, ww) in rows.items())


def evaluate_parallel(boardsize, specs, loader=run_agent_loader, n_envs_per=4, chunk_size=8,
                      n_envs=None, memory_bytes=2 * 1024**3, kind="device", max_workers=2,
                      seed=0, device=None, timeout=None):
    """Farm the league's chunk jobs out over a worker pool and merge their
    trials, summed per (black, white) pair, into one `Trials` (reference
    neural.py:256-274, a 2-worker CUDA pool). `kind="device"`: workers
    pinned to the cards round-robin, or seeing none with `device="cpu"`;
    each plays its jobs on its card (`device` None) or the CPU. `loader`
    is called as ``loader(spec, device)`` in the workers and must pickle,
    as must the specs. Past `timeout` seconds (None: no limit) the workers
    are ended and TimeoutError raised."""
    from ..utils import parallel as upar

    job_args = list(evaluate_gen(boardsize, specs, loader, n_envs_per, chunk_size, n_envs,
                                 memory_bytes, seed))
    start = time.time()
    trials = merge(upar.parallel(partial(_run_chunk, device=device), job_args, kind=kind,
                                 max_workers=max_workers, device=device, timeout=timeout))
    games = float((trials.black_wins + trials.white_wins).sum())
    dt = time.time() - start
    log.info(f"league farm-out: {len(job_args)} jobs, {games:.0f} games in {dt:.1f}s "
             f"({games / max(dt, 1e-9):.1f} games/s)")
    return trials


def evaluate_gen(boardsize, specs, loader=run_agent_loader, n_envs_per=4,
                 chunk_size=8, n_envs=None, memory_bytes=2 * 1024**3, seed=0):
    """The chunk jobs' argument tuples for a league over `specs` (dict
    name -> picklable spec)."""
    for k, (chunk_specs, matchups) in enumerate(chunk_jobs(specs, chunk_size)):
        envs = n_envs or min(len(matchups) * n_envs_per,
                             max_envs(boardsize, memory_bytes=memory_bytes))
        envs = max(envs - envs % 2, 2)
        yield (boardsize, chunk_specs, loader, matchups, n_envs_per, envs, seed + k)


class MockAgent:
    """Plays its own id every time."""

    def __init__(self, action):
        self.action = action

    def __call__(self, world, draws=None, eval=False):
        return {"actions": torch.full((world.n_envs,), self.action, dtype=torch.int32,
                                      device=world.device)}
