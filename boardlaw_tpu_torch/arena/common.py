"""Head-to-head matches and the agent and world loaders. Counterpart of
boardlaw_tpu/arena/common.py.

`evaluate` plays every seat permutation of two agents over a batch of envs
until every game ends, with the JAX package's bookkeeping: each ply, each
agent searches the envs it owns gathered into one sub-batch padded to a
power of two (env 0 repeated), then the full batch takes one step, and
finished envs stay frozen. Agents follow the port's protocol
`agent(world, draws=None, eval=False)`; each agent call takes
`draws.split()` where the JAX package splits its key, so under fed draws the
games equal the JAX package's game for game.

`agent` loads a run's latest or numbered snapshot, the port's checkpoints
and the JAX package's alike, into an `MCTSAgent` whose network is shared by
every agent of its architecture on its device: one module, its weights
swapped in when an agent is called.

`sql_agent`/`sql_world` load an agent, and make its worlds, by its
results-database row (`sql.agent_query`). As in the JAX package,
`sql_agent` searches with the row's `test_nodes` and the run's c_puct: the
row's `test_c` is not applied.
"""
from __future__ import annotations

import time
from dataclasses import fields, replace
from itertools import permutations
from logging import getLogger

import numpy as np
import torch

from .. import sql, train
from ..draws import Draws
from ..envs import hex
from ..mcts.search import MCTSAgent
from ..models import convert
from ..models.networks import make_eval_fn
from ..pavlov import runs, storage as pstorage
from ..utils import resolve_device

log = getLogger(__name__)


def _train_config(spec):
    """The port's TrainConfig from a run's pickled config: the port's, or
    the JAX package's, whose TPU-dataflow fields the port does not carry."""
    names = {f.name for f in fields(train.TrainConfig)}
    return train.TrainConfig(**{k: v for k, v in spec.items() if k in names})


def _state_dict(agent_sd):
    """The torch state dict of a checkpoint's agent part: the port's, or the
    JAX package's flax params (whose optimizer state is a list of leaves),
    converted."""
    if isinstance(agent_sd["opt"], list):
        return convert.from_flax(agent_sd["params"])
    return agent_sd["params"]


def agent(run, idx=None, device=None, **kwargs):
    """The agent of a run's latest (or numbered) snapshot, searching with the
    run's n_nodes and c_puct unless `kwargs` say otherwise; None where the
    run has no model file or no checkpoint."""
    run = runs.resolve(run)
    try:
        spec = pstorage.load_raw(run, "model")
    except OSError:
        log.warning(f'no model file for "{run}"')
        return None
    cfg = _train_config(spec["cfg"])
    try:
        sd = pstorage.load_latest(run) if idx is None else pstorage.load_snapshot(run, idx)
    except (OSError, KeyError):
        log.warning(f'no checkpoint for "{run}"')
        return None

    search = {
        "n_nodes": int(sd["agent"]["kwargs"].get("n_nodes", cfg.n_nodes)),
        "c_puct": float(sd["agent"]["kwargs"].get("c_puct", cfg.c_puct)),
    }
    search.update(kwargs)
    return SharedParamsAgent(cfg, _state_dict(sd["agent"]), search, device)


_MODELS = {}


def _shared_model(cfg, device):
    """One network per architecture and device, shared by its agents."""
    key = (cfg.net, cfg.boardsize, cfg.width, cfg.depth, cfg.dtype, str(device))
    if key not in _MODELS:
        _MODELS[key] = train.build_model(cfg, device=device)
        _MODELS[key].eval()
        _MODELS[key].owner = None
    return _MODELS[key]


class SharedParamsAgent:
    """An `MCTSAgent` over its own weights, on a network module shared with
    every agent of its architecture: a call loads its weights into the
    module unless they are the ones loaded."""

    def __init__(self, cfg, state_dict, search, device=None):
        self.device = resolve_device(device)
        self.model = _shared_model(cfg, self.device)
        self.params = {k: torch.as_tensor(v).to(self.device) for k, v in state_dict.items()}
        self.search = MCTSAgent(make_eval_fn(self.model), **search)

    def __call__(self, world, draws=None, eval=False):
        if self.model.owner is not self:
            self.model.load_state_dict(self.params)
            self.model.owner = self
        return self.search(world, draws, eval=eval)


def sql_agent(agent_id, device=None, **kwargs):
    """The agent of a results-database row, searching with the row's
    `test_nodes` (its `test_c` is not applied, as in the JAX package)."""
    row = sql.agent_query().row(agent_id)
    return agent(row.run, int(row.idx), device=device, n_nodes=int(row.test_nodes), **kwargs)


def sql_world(agent_id, n_envs, device=None):
    """Fresh worlds at the boardsize of a results-database agent's run."""
    row = sql.agent_query().row(agent_id)
    return hex.Hex.initial(n_envs, int(row.boardsize), device=device)


def worlds(run, n_envs, device=None):
    boardsize = runs.info(runs.resolve(run))["params"]["boardsize"]
    return hex.Hex.initial(n_envs, boardsize, device=device)


def matchup_patterns(n_seats):
    return np.array(list(permutations(range(n_seats))))


def matchup_indices(n_envs, n_seats):
    patterns = matchup_patterns(n_seats)
    return np.tile(patterns, (n_envs // len(patterns), 1))


def _take(world, idx):
    """The sub-batch of envs `idx` of a world (a dataclass of (B, ...)
    tensors)."""
    return replace(world, **{f.name: getattr(world, f.name)[idx] for f in fields(world)})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(world, agents, draws=None, max_plies=None):
    """Play each seat-permutation matchup of `agents` over the env batch
    until every game ends. Returns one result dict per permutation with
    (names, wins, moves, games, times, boardsize).

    agents: dict name->agent or list of (name, agent); exactly n_seats
    entries, each called as agent(world, draws, eval=True) -> {'actions'}.
    draws: the `Draws` each agent call splits from (default: seed 0 on the
    world's device). An agent's time is its calls' wall time, the card's
    work included, shared among the live envs it played."""
    if isinstance(agents, dict):
        agents = list(agents.items())
    n_seats = world.n_seats
    B = world.n_envs
    assert n_seats == 2, "only 2-seat games supported"
    assert B % 2 == 0, "n_envs must be divisible by the number of seat permutations"
    assert len(agents) == n_seats

    dev = world.device
    draws = draws if draws is not None else Draws(0, dev)
    matchups = matchup_indices(B, n_seats)  # (B, n_seats) seat -> agent
    envs = np.arange(B)

    done = np.zeros(B, bool)
    wins = np.zeros((B, n_seats))
    moves = np.zeros(B)
    times = np.zeros(B)
    boardsize = getattr(world, "boardsize", 0)
    # a completed Hex game takes at most boardsize^2 plies; the bound is a
    # safety valve against faulty worlds, not a truncation policy
    bound = max_plies or (16 * boardsize**2 if boardsize else 4096)

    ply = 0
    while not done.all():
        if ply >= bound:
            log.warning(f"evaluate: {int((~done).sum())} games still live after {ply} plies "
                        "- aborting (raise max_plies?)")
            break
        ply += 1

        owner = matchups[envs, world.seats.cpu().numpy()]  # (B,) acting agent per env
        buckets = [np.flatnonzero(owner == i) for i in range(len(agents))]

        # one pow2-padded sub-batch search per agent, then one full-batch step
        actions = torch.zeros((B,), dtype=torch.int32, device=dev)
        elapsed = np.zeros(len(agents))
        for i, (name, ag) in enumerate(agents):
            idx = buckets[i]
            if len(idx) == 0:
                continue
            pad = (1 << int(len(idx) - 1).bit_length()) - len(idx)
            pidx = torch.as_tensor(np.concatenate([idx, np.zeros(pad, idx.dtype)]), device=dev)
            sub = draws.split()
            start = time.time()
            decisions = ag(_take(world, pidx), sub, eval=True)
            actions[torch.as_tensor(idx, device=dev)] = \
                decisions["actions"][:len(idx)].to(torch.int32)
            _sync(dev)
            elapsed[i] = time.time() - start

        stepped, transition = world.step(actions)
        live = ~done
        world = hex._where(torch.as_tensor(live, device=dev), stepped, world)

        terminal = transition.terminal.cpu().numpy() & live
        rewards = transition.rewards.cpu().numpy()
        wins[terminal] += rewards[terminal] == 1
        moves[live] += 1
        done |= terminal
        for i in range(len(agents)):
            blive = buckets[i][live[buckets[i]]]
            times[blive] += elapsed[i] / max(len(blive), 1)

    return _gather(wins, moves, times, matchups, agents, boardsize)


def _gather(wins, moves, times, matchups, agents, boardsize):
    """Aggregate per-env outcomes by seat pattern."""
    names = np.array([name for name, _ in agents])
    results = []
    for p in matchup_patterns(matchups.shape[1]):
        sel = (matchups == p).all(-1)
        ws = wins[sel].sum(0)
        results.append({
            "names": tuple(str(n) for n in names[p]),
            "wins": tuple(float(x) for x in ws),
            "moves": float(moves[sel].sum()),
            "games": float(ws.sum()),
            "times": float(times[sel].sum()),
            "boardsize": int(boardsize),
        })
    return results
