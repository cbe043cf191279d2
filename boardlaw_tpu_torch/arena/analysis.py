"""The posterior over a run's arena ledger, and its plots. Counterpart of
boardlaw_tpu/arena/analysis.py.

`solution` solves `activelo` over the run's ledger (numpy, on `device`, the
card unless the caller asks for another); `difference` is the Elo gap of
two agents with its std from the full covariance. `elos` returns a
DataFrame (needs pandas); the figures import matplotlib where they are
drawn.
"""
from __future__ import annotations

import numpy as np

from .. import activelo
from ..pavlov import runs
from . import live


def solution(run, names=None, device=None):
    """The activelo posterior over a run's arena ledger, its fields numpy
    over `names` (default: every agent of the ledger, sorted)."""
    trials = live.ledger_trials(run)
    if names is None:
        names = sorted(set(trials.black_agent) | set(trials.white_agent))
    n, w = live.symmetric_counts(trials, names)
    return activelo.solve(n, w, names=names, device=device)


def difference(soln, a, b):
    """(mean, std) of the Elo gap between agents `a` and `b`."""
    i, j = soln.names.index(a), soln.names.index(b)
    mu, Sigma = np.asarray(soln.mu), np.asarray(soln.Sigma)
    var = Sigma[i, i] - Sigma[i, j] - Sigma[j, i] + Sigma[j, j]
    return float(mu[i] - mu[j]), float(np.sqrt(max(var, 0)))


def elos(run, names=None, device=None):
    """Posterior means and stds, best first: a DataFrame (needs pandas)."""
    pd = runs.require_pandas()
    soln = solution(run, names, device)
    df = pd.DataFrame({"elo": soln.mu, "std": np.sqrt(np.diagonal(soln.Sigma))},
                      index=soln.names)
    return df.sort_values("elo", ascending=False)


def errorbars(run, ax=None, device=None):
    """Elo point estimates with +-2 sigma bars."""
    import matplotlib.pyplot as plt

    df = elos(run, device=device)
    ax = plt.subplots()[1] if ax is None else ax
    ax.errorbar(np.arange(len(df)), df.elo, yerr=2 * df["std"], fmt="o")
    ax.set_xticks(np.arange(len(df)))
    ax.set_xticklabels(df.index, rotation=45, ha="right", fontsize=8)
    ax.set_ylabel("Elo (nats)")
    ax.grid(alpha=0.25)
    return ax.figure


def _matrix(ax, values, names, vmax, cmap, label):
    im = ax.imshow(values, vmin=0, vmax=vmax, cmap=cmap)
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_yticklabels(names, fontsize=7)
    ax.figure.colorbar(im, ax=ax, label=label)
    return ax.figure


def winrate_heatmap(run, ax=None):
    """Pairwise empirical win rates."""
    import matplotlib.pyplot as plt

    trials = live.ledger_trials(run)
    names = sorted(set(trials.black_agent) | set(trials.white_agent))
    n, w = live.symmetric_counts(trials, names)
    ax = plt.subplots()[1] if ax is None else ax
    with np.errstate(divide="ignore", invalid="ignore"):
        return _matrix(ax, w / n, names, 1, "RdBu", "winrate")


def nontransitivity(run, ax=None, device=None):
    """|empirical - implied| win rates under the posterior means."""
    import matplotlib.pyplot as plt

    soln = solution(run, device=device)
    n, w = live.symmetric_counts(live.ledger_trials(run), soln.names)
    mu = np.asarray(soln.mu)
    with np.errstate(divide="ignore", invalid="ignore"):
        resid = np.abs(w / n - 1 / (1 + np.exp(-(mu[:, None] - mu[None, :]))))
    ax = plt.subplots()[1] if ax is None else ax
    return _matrix(ax, resid, soln.names, 0.5, "viridis", "|empirical - implied|")
