"""Maximum-likelihood Elo solver. Counterpart of boardlaw_tpu/elos.py.

Black/white trials fold into symmetric win/game matrices; ratings are the
L-BFGS maximum of the Bradley-Terry likelihood with a small L2 anchor on
their mean, reported relative to the best agent.

Trials are columns `black_agent`, `white_agent`, `black_wins`,
`white_wins`: a pandas DataFrame (as in the JAX package), an
`arena.neural.Trials` table, or any object with those four attributes.
Given a DataFrame, `symmetrize` and `solve` return pandas, as the JAX
package's do; otherwise numpy arrays with a list of names, so the card's
machine, which has no pandas, runs them too.

The loss and its gradient are torch autograd in float32 (the JAX package's
jax.value_and_grad runs in float32 too) on `device`, the card unless the
caller asks for another; scipy's L-BFGS drives it from the host, one
transfer of the value and gradient per evaluation.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.optimize
import torch

from .utils import resolve_device

COLUMNS = ("black_agent", "white_agent", "black_wins", "white_wins")


def _is_frame(x):
    return type(x).__module__.startswith("pandas")


def trial_columns(trials):
    """The four trial columns as numpy arrays (names as str)."""
    black, white, bw, ww = (np.asarray(getattr(trials, c)) for c in COLUMNS)
    return black.astype(str), white.astype(str), bw.astype(float), ww.astype(float)


def symmetric_matrices(trials, names=None):
    """(wins, games, names) of `symmetrize` as numpy arrays over `names`
    (default: every agent of the trials, sorted). wins[i, j] is NaN where
    either colour order of (i, j) has no games, as in the JAX package."""
    black, white, bw, ww = trial_columns(trials)
    names = sorted(set(black) | set(white)) if names is None else list(names)
    ix = {n: i for i, n in enumerate(names)}
    N = len(names)
    games = np.zeros((N, N))  # [black, white]
    bwins = np.zeros((N, N))
    wwins = np.zeros((N, N))
    for b, w, x, y in zip(black, white, bw, ww):
        if b in ix and w in ix:
            games[ix[b], ix[w]] += x + y
            bwins[ix[b], ix[w]] += x
            wwins[ix[b], ix[w]] += y
    total = games + games.T
    with np.errstate(divide="ignore", invalid="ignore"):
        ws = (bwins / games + wwins.T / games.T) / 2 * total
    return np.where(total > 0, ws, np.nan), total, names


def symmetrize(trials):
    """Fold per-(black, white) trial counts into symmetric wins/games
    matrices. A DataFrame gives DataFrames (wins, games) indexed by agent;
    other trials give numpy (wins, games, names)."""
    if not _is_frame(trials):
        return symmetric_matrices(trials)
    import pandas as pd

    if len(trials) == 0:
        ws = pd.DataFrame(0.0, index=trials.index, columns=trials.index)
        gs = pd.DataFrame(0.0, index=trials.index, columns=trials.index)
        return ws, gs
    ws, gs, names = symmetric_matrices(trials)
    idx = pd.Index(names, name="black_agent")
    cols = pd.Index(names, name="white_agent")
    return pd.DataFrame(ws, idx, cols), pd.DataFrame(gs, idx, cols)


def solve(wins, games, prior=1.0, device=None):
    """MLE Bradley-Terry ratings in natural-log units, anchored to the best
    agent at 0. DataFrames in give a Series named "elo"; numpy in, numpy
    out."""
    frame = _is_frame(wins)
    if frame:
        import pandas as pd

        pd.testing.assert_index_equal(wins.index, games.index)
        pd.testing.assert_index_equal(wins.index, wins.columns, check_names=False)
        index, wins, games = wins.index, wins.values, games.values
    dev = resolve_device(device)
    f32 = torch.float32
    # C order whatever the frame's layout: the float32 sums, and so the
    # point where L-BFGS stops, depend on the order of the elements
    wins = np.ascontiguousarray(wins, float)
    games = np.ascontiguousarray(games, float)
    W = torch.tensor(np.nan_to_num(wins, nan=0.0), dtype=f32, device=dev) + prior
    N = torch.tensor(np.nan_to_num(games, nan=0.0), dtype=f32, device=dev) + 2 * prior
    mask = torch.tensor(games > 0, device=dev)
    denom = max(int(mask.sum()), 1)

    def loss(r):
        s = torch.sigmoid(r[:, None] - r[None, :])
        ll = W * torch.log(s) + (N - W) * torch.log1p(-s)
        return -(torch.where(mask, ll, 0.0).sum() / denom) + 0.01 * r.mean().square()

    res = scipy.optimize.minimize(_value_and_grad(loss, dev), np.zeros(len(wins)), jac=True,
                                  method="L-BFGS-B")
    r = res.x - res.x.max()
    if frame:
        return pd.Series(r, index, name="elo")
    return r


def _value_and_grad(loss, device):
    """scipy's fun(x) -> (value, gradient) over a float32 torch loss on
    `device`: one host transfer of both per evaluation."""
    def f(x):
        t = torch.tensor(x, dtype=torch.float32, device=device, requires_grad=True)
        v = loss(t)
        (g,) = torch.autograd.grad(v, t)
        out = torch.cat([v.detach().reshape(1), g]).cpu().numpy().astype(np.float64)
        return float(out[0]), out[1:]

    return f


def elo_errors(elos, trials, names=None):
    """Max |empirical - implied| win rate per agent. `elos` a Series (its
    index the names) or an array over `names`; returns the same kind."""
    frame = _is_frame(elos)
    if frame:
        import pandas as pd

        names = list(elos.index)
    values = np.asarray(elos, float)
    ws, gs, _ = symmetric_matrices(trials, names)
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = ws / gs
    expected = 1 / (1 + np.exp(-(values[:, None] - values[None, :])))
    err = np.abs(rates - expected)
    with warnings.catch_warnings():  # an all-NaN row gives NaN, as pandas' max does
        warnings.simplefilter("ignore", RuntimeWarning)
        out = np.fmax(np.nanmax(err, 0), np.nanmax(err, 1))
    return pd.Series(out, elos.index) if frame else out
