"""Training-time evaluation: a rolling arena scoring the latest checkpoint
against a reference ladder, with active matchmaking and a Bayesian Elo
posterior. Counterpart of boardlaw_tpu/arena/live.py.

A spawned process reloads the run's latest checkpoint every `interval`
seconds, plays it against the ladder opponent whose game is the most
informative, keeps the cumulative game ledger in the run's `arena-games`
JSON file, solves the activelo posterior over it and writes the latest
agent's Elo relative to the best rung, with its std, to the run's
`elo-arena` stats channel.

The default ladder is a search-compute ladder: MCTS over uniform-random
evaluations at geometrically increasing node counts. `ladder="external"`
takes the GTP-engine randomization ladder (MoHex where present, the bundled
gtphex engine otherwise).

The JAX package's child pins itself to the CPU, since a TPU chip serves
one process. The port's child evaluates on the card beside the learner
(`device`, the card unless the caller asks for another); spawned, it builds
its own CUDA context and touches none of the parent's. Everything here
works on numpy arrays with agent names, so the card's machine needs no
pandas.
"""
from __future__ import annotations

import multiprocessing as mp
import time
from logging import getLogger

import numpy as np

from .. import activelo
from ..draws import Draws
from ..envs import validation
from ..mcts.search import MCTSAgent
from ..pavlov import json_store, logs, runs, stats
from ..utils import resolve_device
from . import common
from .neural import Trials

log = getLogger(__name__)

LEDGER = "arena-games"
LATEST = "latest"
# the live arena's search for the latest agent: the K=8 grow route (the JAX
# child's {"leaves_per_pass": 8, "use_pallas": False, "grow_passes": True})
SEARCH = {"leaves_per_pass": 8, "grow_passes": True}


def rollout_ladder(nodes=(1, 4, 16, 64)):
    """Reference opponents: pure-rollout MCTS at increasing search budgets."""
    ladder = {}
    for n in nodes:
        if n <= 1:
            ladder["rollout-1"] = _random_agent()
        else:
            ladder[f"rollout-{n}"] = MCTSAgent(validation.RandomAgent(), n_nodes=n,
                                               noise_eps=0.0)
    return ladder


def external_ladder(randoms=(1.0, 0.75, 0.5, 0.0), command=None, **kwargs):
    """The external-engine randomization ladder: MoHex blended with uniform
    random moves at decreasing rates; the bundled gtphex engine where no
    MoHex binary exists. A real GTP subprocess either way."""
    from .. import gtp_engine, mohex

    if command is None and not mohex.available():
        command = gtp_engine.command()
    return {f"ext-{r:g}": mohex.MoHexAgent(random=r, command=command, **kwargs)
            for r in randoms}


class _RandomAgent:
    """A uniform random valid move, drawn from `draws` as the JAX package's
    `jax.random.categorical` draws it."""

    def __init__(self):
        self.inner = validation.RandomAgent()

    def __call__(self, world, draws=None, eval=False):
        return self.inner(world, draws if draws is not None else Draws(0, world.device))


def _random_agent():
    return _RandomAgent()


def record_result(run, black, white, black_wins, white_wins):
    def add(obj):
        rec = obj.setdefault(f"{black}|{white}", {"black_wins": 0.0, "white_wins": 0.0})
        rec["black_wins"] += black_wins
        rec["white_wins"] += white_wins

    json_store.update(run, LEDGER, add)


def ledger_trials(run):
    """The run's ledger as `Trials`."""
    return Trials((*key.split("|"), rec["black_wins"], rec["white_wins"])
                  for key, rec in json_store.read(run, LEDGER).items())


def symmetric_counts(trials, names):
    """(games, wins) matrices over `names`: wins[i, j] are i's wins against
    j in either colour. numpy for `Trials`; DataFrames for a DataFrame."""
    from ..elos import _is_frame, trial_columns

    ix = {n: i for i, n in enumerate(names)}
    n = np.zeros((len(names), len(names)))
    w = np.zeros_like(n)
    for b, wh, bw, ww in zip(*trial_columns(trials)):
        if b not in ix or wh not in ix:
            continue
        i, j = ix[b], ix[wh]
        n[i, j] += bw + ww
        n[j, i] += bw + ww
        w[i, j] += bw
        w[j, i] += ww
    if _is_frame(trials):
        import pandas as pd

        return pd.DataFrame(n, names, names), pd.DataFrame(w, names, names)
    return n, w


class RollingArena:
    """Keeps a cumulative ledger of latest-vs-ladder games, solving the
    posterior and choosing the most informative challenger each round."""

    def __init__(self, run, n_envs=32, ladder=None, search_kwargs=None, device=None):
        self.run = runs.resolve(run)
        self.n_envs = n_envs
        self.ladder = ladder or rollout_ladder()
        self.search_kwargs = search_kwargs or {}
        self.device = resolve_device(device)
        self.soln = None
        self.seed = 0

    def _solve(self, names, when):
        n, w = symmetric_counts(ledger_trials(self.run), names)
        try:
            self.soln = activelo.solve(n, w, soln=self.soln, names=names, device=self.device)
        except Exception as e:
            log.warning(f"activelo failed{when}: {e}")
            self.soln = None
        return n

    def play(self, agent=None):
        """One round: the latest agent against the chosen rung. Returns the
        latest agent's Elo relative to the best rung, or None."""
        agent = agent or common.agent(self.run, device=self.device, **self.search_kwargs)
        if agent is None:
            return None

        names = [LATEST] + list(self.ladder)
        n = self._solve(names, "")
        if self.soln is not None and n[0].sum() > 0:
            imp = activelo.improvement(self.soln)[0, 1:]  # LATEST's row, without itself
            challenger = names[1 + int(np.nanargmax(imp))]
        else:
            challenger = names[1]

        self.seed += 1
        world = common.worlds(self.run, self.n_envs, device=self.device)
        results = common.evaluate(world, {LATEST: agent, challenger: self.ladder[challenger]},
                                  draws=Draws(self.seed, self.device))
        for r in results:
            black, white = r["names"]
            record_result(self.run, black, white, r["wins"][0], r["wins"][1])

        self._solve(names, " after games")
        if self.soln is None:
            return None
        mu, Sigma = self.soln.mu, self.soln.Sigma
        best = 1 + int(np.argmax(mu[1:]))
        rel = float(mu[0] - mu[best])
        # the std of the pairwise gap, covariance included
        var = Sigma[0, 0] - Sigma[0, best] - Sigma[best, 0] + Sigma[best, best]
        sigma_d = float(np.sqrt(max(var, 0)))
        stats.mean_std("elo-arena", rel, sigma_d)
        log.info(f"arena: latest elo {rel:+.2f} ± {sigma_d:.2f} vs {names[best]} "
                 f"(played {challenger})")
        return rel


def _loop(run, interval, ladder="rollout", device=None):
    arena = RollingArena(run, ladder=external_ladder() if ladder == "external" else None,
                         search_kwargs=SEARCH, device=device)
    # the child's own logs.{n}.txt and stats writers in the run dir
    with logs.to_run(run), stats.to_run(run):
        while True:
            try:
                arena.play()
            except Exception as e:  # keep evaluating through transient errors
                log.warning(f"arena loop error: {e}")
            time.sleep(interval)


def run(run_name, interval=15, ladder="rollout", device=None):
    """Spawn the background arena process for a run; returns the Process
    (a daemon: call .terminate() when training ends). `device` is where the
    child evaluates, the card unless the caller asks for another."""
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_loop, args=(runs.resolve(run_name), interval, ladder, device),
                    daemon=True)
    p.start()
    return p
