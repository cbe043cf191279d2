"""Paper figures: compute-vs-Elo curves, frontiers, residual variance, the
train/test-compute trade-off, model sizes and the MoHex calibration, and the
paper's tables. Counterpart of boardlaw_tpu/scaling/paper.py.

Each figure takes the agents frame of `data.load()` (pandas) and returns a
matplotlib Figure; matplotlib is imported where a figure is drawn, so the
module imports on a machine without it. The fits run on `device`, the card
unless the caller asks for another.
"""
from __future__ import annotations

import numpy as np
import torch

from ..pavlov import runs
from . import data


def _plt():
    import matplotlib.pyplot as plt

    return plt


def flops_curves(ags, ax=None):
    """Per-run Elo-vs-train-FLOPs curves, one panel color per boardsize
    (reference analysis/paper.py flops plots)."""
    plt = _plt()
    ax = plt.subplots(figsize=(7, 4))[1] if ax is None else ax
    for b, g in ags.groupby("boardsize"):
        for run, gg in g.groupby("run"):
            gg = gg.sort_values("train_flops")
            ax.plot(
                gg.train_flops, data.ELO * gg.elo, alpha=0.4,
                color=plt.cm.viridis((b - 3) / 7),
            )
    ax.set_xscale("log")
    ax.set_xlabel("train FLOPs")
    ax.set_ylabel("Elo vs best (base-10/400)")
    ax.grid(alpha=0.25)
    return ax.figure


def frontiers(ags, ax=None, device=None):
    """Upper-envelope frontier per boardsize plus the fitted changepoint
    model."""
    plt = _plt()
    ax = plt.subplots(figsize=(7, 4))[1] if ax is None else ax
    df, params = data.modelled_elos(ags, device=device)
    for b, g in df.groupby("boardsize"):
        color = plt.cm.viridis((b - 3) / 7)
        ax.plot(g.train_flops, data.ELO * g.elo, color=color, label=f"{b}x{b}")
        ax.plot(g.train_flops, data.ELO * g.elohat, color=color, linestyle="--")
    ax.set_xscale("log")
    ax.set_xlabel("train FLOPs")
    ax.set_ylabel("frontier Elo")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.25)
    return ax.figure


def resid_var(ags, ax=None, device=None):
    """Residual variance of the frontier fit by boardsize."""
    plt = _plt()
    ax = plt.subplots(figsize=(5, 3))[1] if ax is None else ax
    df, params = data.modelled_elos(ags, device=device)
    resid = (df.elo - df.elohat).groupby(df.boardsize).apply(lambda s: (s ** 2).mean())
    var = df.elo.groupby(df.boardsize).var()
    (resid / var).plot.bar(ax=ax)
    ax.set_ylabel("resid var fraction")
    return ax.figure


def perfect_play_flops(ags, ax=None, device=None):
    """Extrapolated FLOPs to perfect play per boardsize."""
    plt = _plt()
    ax = plt.subplots(figsize=(5, 3))[1] if ax is None else ax
    df, params = data.modelled_elos(ags, device=device)
    perfect = data.perfect_play(params)
    ax.plot(list(perfect), list(perfect.values()), marker="o")
    ax.set_xlabel("boardsize")
    ax.set_ylabel("log10 FLOPs to perfect play")
    ax.grid(alpha=0.25)
    return ax.figure


def hex_board(boardsize=9, seed=8, n_moves=20, ax=None):
    """A mid-game Hex position, the paper's figure 1: `n_moves` uniform
    random moves of the port's Hex on the CPU, from `Draws(seed)`."""
    from ..draws import Draws
    from ..envs import hex

    world = hex.Hex.initial(1, boardsize, device="cpu")
    draws = Draws(seed, "cpu")
    for _ in range(n_moves):
        logits = torch.where(world.valid, 0.0, -torch.inf)
        world, _ = world.step(torch.argmax(logits + draws.gumbel(logits.shape), -1))
    colors = hex.color_board(world.board[0].numpy(), "board")
    return hex.plot_board(colors, ax=ax).figure


def runtimes(ags, elo_threshold=-50, ax=None):
    """Wall-clock training time of the cheapest run reaching near-perfect
    play, by boardsize (reference analysis/paper.py:110-124)."""
    plt = _plt()
    ax = plt.subplots(figsize=(5, 3))[1] if ax is None else ax
    aug = data.with_times(ags)
    thresh = elo_threshold / data.ELO
    best = (
        aug[aug.elo > thresh]
        .sort_values("train_time")
        .groupby("boardsize")
        .first()
        .reset_index()
    )
    ax.scatter(best.boardsize, best.train_time, c=best.boardsize, cmap="viridis")
    ax.set_yscale("log")
    ax.set_xlabel("board size")
    ax.set_ylabel("training time (s)")
    ax.grid(alpha=0.25)
    return ax.figure


def train_test(ags, ax=None):
    """Iso-Elo train-compute vs test-compute frontier trade-off (reference
    analysis/paper.py:151-170)."""
    plt = _plt()
    ax = plt.subplots(figsize=(6, 4))[1] if ax is None else ax
    frontiers = data.train_test(ags)
    if len(frontiers) == 0:
        return ax.figure
    frontiers, coef = data.train_test_model(frontiers)
    for e, g in frontiers.groupby("elo"):
        g = g.sort_values("train_flops")
        color = plt.cm.viridis((e + 1500) / 1500)
        ax.plot(g.train_flops, g.test_flops, color=color, label=f"{e:.0f}")
        ax.plot(g.train_flops, g.test_flops_hat, color=color, linestyle="--", lw=0.5)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("train compute (FLOPs)")
    ax.set_ylabel("test compute (FLOPs)")
    ax.set_title(
        f"log10(test) = {coef['log10_train']:.2f} log10(train) "
        f"+ {coef['elo']:.2g} elo + {coef['intercept']:.1f}",
        fontsize=8,
    )
    ax.legend(fontsize=6, title="Elo")
    ax.grid(alpha=0.25)
    return ax.figure


def residual_vars(ags, ax=None, device=None):
    """Transfer error: frontiers fitted through boardsize b predicting
    larger boards (reference analysis/paper.py:95-108)."""
    plt = _plt()
    ax = plt.subplots(figsize=(5, 3))[1] if ax is None else ax
    rv = data.residual_vars(ags, device=device)
    for b, g in rv.groupby("predicted"):
        g = g.sort_values("seen")
        ax.plot(g.seen, g.rv, marker="o", ms=3, label=f"<= {b}")
    ax.set_yscale("log")
    ax.set_xlabel("max board size observed")
    ax.set_ylabel("residual variance")
    ax.legend(fontsize=6, title="fitted on")
    ax.grid(alpha=0.25)
    return ax.figure


def optimal_model_size(ags, ax=None):
    """Best model size as a function of the compute budget, with the fitted
    power law (reference analysis/paper.py:186-227)."""
    plt = _plt()
    ax = plt.subplots(figsize=(6, 4))[1] if ax is None else ax
    rows = []
    for b, g in ags.groupby("boardsize"):
        ordered = g.sort_values("elo").copy()
        ordered["params"] = ordered.width**2 * ordered.depth
        left = np.log10(g.train_flops.min())
        right = np.log10(g.train_flops.max())
        for f in np.linspace(left, right, 11)[1:]:
            subset = ordered[ordered.train_flops <= 10**f]
            if len(subset):
                rows.append(
                    {"boardsize": b, "approx_flops": 10**f,
                     "params": subset.params.iloc[-1]}
                )
    if not rows:
        return ax.figure
    df = runs.require_pandas().DataFrame(rows)

    X = np.stack([np.ones(len(df)), np.log10(df.approx_flops.values)], 1)
    y = np.log10(df.params.values)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)

    for b, g in df.groupby("boardsize"):
        g = g.sort_values("approx_flops")
        ax.plot(g.approx_flops, g.params, label=f"{b}x{b}",
                color=plt.cm.viridis((b - 3) / 7))
    xs = np.logspace(np.log10(df.approx_flops.min()),
                     np.log10(df.approx_flops.max()), 21)
    ax.plot(xs, 10 ** (coef[0] + coef[1] * np.log10(xs)), "k--", lw=0.75,
            label=f"10^({coef[1]:.2f} log10(C) {coef[0]:+.1f})")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("train compute (FLOPs)")
    ax.set_ylabel("optimal model size (params)")
    ax.legend(fontsize=6)
    ax.grid(alpha=0.25)
    return ax.figure


def calibrations(ax=None):
    """Best-agent winrate vs MoHex with beta-posterior bands (reference
    analysis/paper.py:172-184)."""
    plt = _plt()
    ax = plt.subplots(figsize=(5, 3))[1] if ax is None else ax
    best = data.sample_calibrations()
    if len(best) == 0:
        return ax.figure
    ax.axhline(0.5, alpha=0.3)
    ax.bar(best.boardsize, best.upper - best.lower, bottom=best.lower,
           width=0.5, alpha=0.6)
    ax.scatter(best.boardsize, best.mid, color="k", zorder=3, s=12)
    ax.set_xlabel("board size")
    ax.set_ylabel("win rate vs MoHex")
    ax.set_ylim(0.3, 0.7)
    return ax.figure


# -- tables -----------------------------------------------------------------

def hyperparams_table():
    pd = runs.require_pandas()

    s = pd.Series(
        {
            "Number of envs": "32k",
            "Batch size": "32k",
            "Buffer size": "2m samples",
            "Learning rate": "1e-3",
            "MCTS node count": 64,
            "MCTS c_puct": "1/16",
            "MCTS noise eps": "1/4",
        }
    )
    return s.to_frame("value")


def boardsize_hyperparams_table(ags):
    return (
        ags.groupby("boardsize")[["width", "depth", "samples", "train_flops"]]
        .max()
        .rename(
            columns={
                "width": "Neurons",
                "depth": "Layers",
                "samples": "Samples",
                "train_flops": "Compute",
            }
        )
    )


def parameters_table(ags, device=None):
    """Fitted frontier parameters, in public-Elo units."""
    pd = runs.require_pandas()

    df, params = data.modelled_elos(ags, device=device)
    rows = {}
    for k, v in params.items():
        arr = np.atleast_1d(v.numpy())
        for i, x in enumerate(arr):
            rows[f"{k}[{i}]"] = data.ELO * float(x)
    return pd.Series(rows, name="value").to_frame()
