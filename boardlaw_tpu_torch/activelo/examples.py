"""Synthetic-tournament demos of the activelo rating system. Counterpart of
boardlaw_tpu/activelo/examples.py: everything generated from a numpy seed,
the simulations returning plain numpy traces. The solves run on `device`,
the card unless the caller asks for another.
"""
from __future__ import annotations

import numpy as np

from . import plot, solvers, suggestions


def winrate(black, white):
    """P(black wins) under the Bradley-Terry model the solver assumes."""
    return 1.0 / (1.0 + np.exp(-(black - white)))


def generated_example(n_agents=20, games_scale=50, seed=0, show=False, device=None):
    """A random complete tournament: draw true ratings, binomial game
    outcomes at every pairing, then recover the ratings
    (reference examples/solvers.py:8-18)."""
    rng = np.random.default_rng(seed)
    truth = rng.normal(size=n_agents)
    n = rng.integers(1, games_scale, (n_agents, n_agents)).astype(float)
    np.fill_diagonal(n, 0)
    w = rng.binomial(n.astype(int), winrate(truth[:, None], truth[None, :]))

    soln = solvers.solve(n, w, device=device)
    if show:
        plot.diagnostics(soln)
    return truth, soln


def reuse_example(n_agents=12, seed=0, repeats=8, device=None):
    """Re-solving with `soln=` warm starts from the previous posterior —
    the uncertainty estimate stays stable across repeats instead of
    re-converging from scratch (reference examples/solvers.py:44-54).

    Returns the per-repeat sigma of the last agent vs the first."""
    truth, soln = generated_example(n_agents, seed=seed, device=device)
    n, w = soln.n, soln.w
    sigmas = []
    for _ in range(repeats):
        soln = solvers.solve(n, w, soln=soln, device=device)
        sigmas.append(float(soln.sigmad[0, -1]))
    return np.asarray(sigmas)


# -- rank families (reference examples/suggestions.py:86-103) ---------------

def linear_ranks(n_agents=10):
    return np.linspace(1, 5, n_agents)


def log_ranks(n_agents=10):
    return np.log(np.linspace(1, 50, n_agents))


def pow_ranks(n_agents=10, power=0.5):
    return np.linspace(1, 50, n_agents) ** power


def random_ranks(n_agents=10, seed=0):
    rng = np.random.default_rng(seed)
    totals = np.cumsum(rng.normal(size=n_agents) / n_agents**0.5)
    return np.sort(totals - totals.min())


def residual_vs_mean(Sigma):
    """Variance of each rating's residual against the mean agent
    (reference examples/suggestions.py:11-12)."""
    Sigma = np.asarray(Sigma)
    return np.diag(Sigma - np.outer(Sigma.mean(0), Sigma.mean(0)) / Sigma.mean())


def resid_var(ranks, truth):
    """Fraction of the truth's (centered) variance the solved ranks miss
    (reference examples/suggestions.py:14-15)."""
    truth_c = truth - truth.mean()
    ranks_c = ranks - ranks.mean()
    return float(((truth_c - ranks_c) ** 2).sum() / (truth_c**2).sum())


def simulate(truth, n_games=256, sigresid_tol=0.1, max_rounds=100, seed=0, device=None):
    """Active-matchmaking loop: each round `suggest` picks the most
    informative pairing, a binomial block of games is played there, and the
    posterior re-solves (warm-started) — stopping when the mean residual
    uncertainty drops below tol (reference examples/suggestions.py:52-84).

    Returns a trace of dict rows (mu, sigresid, resid_var, games so far).
    """
    rng = np.random.default_rng(seed)
    truth = np.asarray(truth, float)
    N = len(truth)
    wins = np.zeros((N, N))
    games = np.zeros((N, N))

    trace = []
    soln = None
    for _ in range(max_rounds):
        soln = solvers.solve(games, wins, soln=soln, device=device)
        black, white = suggestions.suggest(soln)
        black_wins = rng.binomial(n_games, winrate(truth[black], truth[white]))
        wins[black, white] += black_wins
        wins[white, black] += n_games - black_wins
        games[black, white] += n_games
        games[white, black] += n_games

        sigresid = float(np.sqrt(residual_vs_mean(soln.Sigma).mean()))
        trace.append(
            {
                "mu": np.asarray(soln.mu).copy(),
                "sigresid": sigresid,
                "resid_var": resid_var(np.asarray(soln.mu), truth),
                "games": float(games.sum() / 2),
                "suggestion": (int(black), int(white)),
            }
        )
        if sigresid < sigresid_tol:
            break
    return trace


def simulate_log_ranks(n_agents=10, **kwargs):
    """The reference's canonical demo: active matchmaking on a log-spaced
    ladder (reference examples/suggestions.py:81-84)."""
    truth = log_ranks(n_agents)
    trace = simulate(truth, **kwargs)
    return truth, trace
