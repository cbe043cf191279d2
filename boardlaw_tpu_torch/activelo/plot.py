"""Posterior diagnostics: rating means with their uncertainty beside the
pairwise information-gain map that drives matchmaking. Counterpart of
boardlaw_tpu/activelo/plot.py; matplotlib is imported where a figure is
drawn, and `example`'s solves run on `device`, the card unless the caller
asks for another.
"""
from __future__ import annotations

import numpy as np

from . import suggestions


def diagnostics(soln, names=None):
    import matplotlib.pyplot as plt

    mu = np.asarray(soln.mu)
    sigma = np.sqrt(np.diagonal(np.asarray(soln.Sigma)))
    names = list(names) if names is not None else list(range(len(mu)))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    order = np.argsort(mu)[::-1]
    ax1.errorbar(np.arange(len(mu)), mu[order], yerr=2 * sigma[order], fmt="o")
    ax1.set_xticks(np.arange(len(mu)))
    ax1.set_xticklabels([names[i] for i in order], rotation=45, ha="right", fontsize=8)
    ax1.set_ylabel("rating (nats)")
    ax1.set_title("posterior ratings ±2σ")
    ax1.grid(alpha=0.25)

    imp = np.asarray(suggestions.improvement(soln))
    im = ax2.imshow(imp, cmap="viridis")
    ax2.set_title("expected information gain")
    ax2.set_xticks(np.arange(len(mu)))
    ax2.set_yticks(np.arange(len(mu)))
    ax2.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax2.set_yticklabels(names, fontsize=7)
    fig.colorbar(im, ax=ax2)
    fig.tight_layout()
    return fig


def example(n_agents=6, n_rounds=40, seed=0, device=None):
    """Synthetic-tournament demo (reference activelo/examples/suggestions.py):
    agents with hidden true ratings play actively-chosen pairs; returns the
    final solution and the sequence of suggested pairs."""
    from . import solvers

    rng = np.random.default_rng(seed)
    true = np.linspace(1.5, -1.5, n_agents)
    n = np.zeros((n_agents, n_agents))
    w = np.zeros((n_agents, n_agents))
    soln = None
    picks = []
    for _ in range(n_rounds):
        soln = solvers.solve(n, w, soln=soln, device=device)
        i, j = suggestions.suggest(soln)
        if i == j:
            j = (i + 1) % n_agents
        p = 1 / (1 + np.exp(-(true[i] - true[j])))
        win = rng.random() < p
        n[i, j] += 1
        n[j, i] += 1
        w[i, j] += win
        w[j, i] += 1 - win
        picks.append((i, j))
    return solvers.solve(n, w, soln=soln, device=device), picks
