"""Compute-frontier analysis: agents with their Elos, each run's curve
interpolated, the frontier model fitted and extrapolated to perfect play.
Counterpart of boardlaw_tpu/scaling/data.py.

The model's core runs without pandas: `model_inputs`, `changepoint_apply`,
`sigmoid_apply`, `fit_model` and `perfect_play` take any object with
`train_flops`, `boardsize` and `elo` arrays (a DataFrame, `sql.Rows`, a
namespace). Parameters are dicts of float32 tensors. `fit_model` is the JAX
package's fit: scipy's differential evolution over a float32 least-squares
loss, then a Nelder-Mead polish; the loss runs in torch on `device`, the
card unless the caller asks for another, one host sync per evaluation. The
DataFrame functions (`load`, `interp_curves`, `interp_frontier`, `apply_model`,
`modelled_elos`, `with_times`, `residual_vars`, `train_test`,
`train_test_model`, `sample_calibrations`) return pandas, as the JAX
package's do, and import it where they are called.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from .. import elos, sql
from ..pavlov import runs
from ..utils import resolve_device

# Internal Elos are in nats; public Elos are base 10^(d/400)
ELO = 400 / np.log(10)

# Feature centering of the model's inputs, [log10 flops, boardsize]
_CENTER = (12.0, 6.0)


def trial_elos_of(trials, device=None):
    """MLE Elos of the agents of `sql.Rows` trials: a Series named "elo"
    indexed by agent id (needs pandas)."""
    pd = runs.require_pandas()
    if len(trials) == 0:
        return pd.Series(dtype=float, name="elo")
    ws, gs, ids = sql.trial_matrices(trials)
    return pd.Series(elos.solve(ws, gs, device=device), pd.Index(ids, name="black_agent"),
                     name="elo")


def trial_elos(boardsize, desc=None, device=None):
    """`trial_elos_of` a boardsize's trials (needs pandas)."""
    return trial_elos_of(sql.trial_query(boardsize, desc), device)


def load(desc=None, device=None):
    """`agents_details` joined to each boardsize's Elos (needs pandas)."""
    pd = runs.require_pandas()
    ags = sql.agent_query().frame()
    es = [trial_elos(int(b), desc, device) for b in sorted(ags.boardsize.dropna().unique())]
    if not es:
        return ags.iloc[:0]
    return ags.join(pd.concat(es), how="inner")


def interp_curves(g, x="train_flops", y="elo", group="run"):
    """Each run's curve interpolated onto a common log-x grid (needs
    pandas)."""
    pd = runs.require_pandas()
    xl, xr = np.log10(g[x]).min(), np.log10(g[x]).max()
    xs = np.linspace(xl, xr, 101)
    ys = {}
    for run, gg in g.sort_values(x).groupby(group):
        ys[run] = np.interp(xs, np.log10(gg[x].values), gg[y].values, np.nan, np.nan)
    return pd.DataFrame(ys, index=10 ** xs)


def interp_frontier(g, x="train_flops", y="elo", **kwargs):
    """The upper envelope over runs (needs pandas)."""
    ys = interp_curves(g, x=x, y=y, **kwargs)
    return ys.ffill().max(1).rename_axis(index=x).rename(y)


# -- frontier models --------------------------------------------------------

def changepoint_init():
    return {"plateau": torch.tensor([-1.5, 3.0]),  # boardsize, offset
            "incline": torch.tensor([2.0, -2.0, -16.0])}  # log-flops, boardsize, offset


def _augmented(X):
    Xc = X - torch.tensor(_CENTER, dtype=X.dtype, device=X.device)
    return torch.cat([Xc, torch.ones_like(Xc[:, :1])], -1)


def changepoint_apply(params, X):
    """elo = min(max(incline, plateau), 0)."""
    Xa = _augmented(X)
    plateau = Xa[:, 1:] @ params["plateau"]
    incline = Xa @ params["incline"]
    return torch.clamp(torch.maximum(incline, plateau), max=0.0)


def sigmoid_init():
    return {"scale": torch.tensor([1 / 16.0, 0.0]), "height": torch.tensor(1.3),
            "center": torch.tensor([0.66, 9.0])}


def sigmoid_apply(params, X):
    """An alternative saturating frontier."""
    Xa = _augmented(X)
    hscale = Xa[:, 1:] @ params["scale"]
    vscale = hscale * params["height"]
    center = Xa[:, 1:] @ params["center"]
    return vscale * (torch.sigmoid((Xa[:, 0] - center) / hscale) - 1)


def model_inputs(df, device="cpu"):
    """(N, 2) float32 [log10 flops, boardsize]."""
    flops = torch.tensor(np.asarray(df.train_flops, np.float32), device=device)
    boards = torch.tensor(np.asarray(df.boardsize, np.float32), device=device)
    return torch.stack([torch.log10(flops), boards], -1)


def _ravel(params):
    """A parameter dict as one float64 vector (keys sorted, as JAX's
    ravel_pytree orders them) and the function that takes a vector back."""
    keys = sorted(params)
    shapes = [params[k].shape for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = np.concatenate([params[k].reshape(-1).numpy() for k in keys]).astype(np.float64)

    def unravel(theta):
        out, i = {}, 0
        for k, shape, n in zip(keys, shapes, sizes):
            out[k] = theta[i:i + n].reshape(shape)
            i += n
        return out

    return flat, unravel


def fit_model(df, init=changepoint_init, apply=changepoint_apply, seed=0, device=None):
    """Least-squares fit of a frontier model to `df`'s (train_flops,
    boardsize, elo): differential evolution over bounds of +-30 with
    scipy's own L-BFGS polish, then Nelder-Mead from its best point; the
    float32 loss on `device`. Returns the parameters as CPU float32
    tensors."""
    dev = resolve_device(device)
    X = model_inputs(df, dev)
    y = torch.tensor(np.asarray(df.elo, np.float32), device=dev)
    p0, unravel = _ravel(init())

    def f(theta):
        t = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        return float((y - apply(unravel(t), X)).square().mean())

    bounds = [(-30.0, 30.0)] * len(p0)
    res = scipy.optimize.differential_evolution(f, bounds, seed=seed, maxiter=300, tol=1e-10,
                                                polish=True, init="sobol")
    polish = scipy.optimize.minimize(f, res.x, method="Nelder-Mead",
                                     options={"maxiter": 4000, "xatol": 1e-9, "fatol": 1e-12})
    best = polish.x if polish.fun < res.fun else res.x
    return unravel(torch.as_tensor(best, dtype=torch.float32))


def apply_model(params, df, apply=changepoint_apply):
    """The model's Elos at `df`'s rows, a Series on `df`'s index (needs
    pandas)."""
    pd = runs.require_pandas()
    return pd.Series(apply(params, model_inputs(df)).numpy(), df.index)


def perfect_play(params, target=-50, apply=changepoint_apply, boardsizes=range(3, 10)):
    """{boardsize: log10 flops} at which the model comes within `target`
    public Elo of perfect play (NaN where it never does in 1..18)."""
    perfect = {}
    for b in boardsizes:
        def f(x):
            X = torch.tensor([[x, float(b)]], dtype=torch.float32)
            return ELO * float(apply(params, X)[0]) - target

        try:
            perfect[b] = scipy.optimize.bisect(f, 1, 18)
        except ValueError:
            perfect[b] = np.nan
    return perfect


def _frontiers(ags):
    """Each boardsize's frontier, stacked (needs pandas)."""
    pd = runs.require_pandas()
    frames = []
    for b, g in ags.groupby("boardsize"):
        f = interp_frontier(g, "train_flops").reset_index()
        f.insert(0, "boardsize", b)
        frames.append(f)
    return pd.concat(frames, ignore_index=True).dropna(subset=["elo"])


def modelled_elos(ags, device=None):
    """The frontier of each boardsize and the model fitted to them: (frame
    with `elohat`, parameters) (needs pandas)."""
    df = _frontiers(ags)
    params = fit_model(df, device=device)
    df["elohat"] = apply_model(params, df)
    return df, params


def with_times(ags):
    """Agents with each run's sample rate (from its `count.samples`
    channel) and the training time it implies per snapshot (needs
    pandas)."""
    from ..pavlov import stats

    pd = runs.require_pandas()
    rates = {}
    for r in ags.run.unique():
        try:
            arr = stats.pandas(r, "count.samples")
        except Exception:
            continue
        if arr.empty or len(arr) < 2:
            continue
        dt = (arr.index[-1] - arr.index[0]).total_seconds()
        if dt > 0:
            rates[r] = (arr.total.sum() - arr.total.iloc[0]) / dt
    rates = pd.Series(rates, name="sample_rate", dtype=float)
    rates.index = rates.index.astype(str)
    aug = pd.merge(ags.assign(run=ags.run.astype(str)), rates, left_on="run", right_index=True)
    aug["train_time"] = aug.samples / aug.sample_rate
    return aug


def residual_vars(ags, device=None):
    """How well frontiers fitted on boards <= b predict the frontiers of
    larger boards: rows of (predicted, seen, rv) (needs pandas)."""
    pd = runs.require_pandas()
    df = _frontiers(ags)
    rows = []
    for b in sorted(df.boardsize.unique())[:-1]:
        params = fit_model(df[df.boardsize <= b], device=device)
        pred = apply_model(params, df[df.boardsize >= b])
        sub = df.loc[pred.index]
        num = (pred - sub.elo).pow(2).groupby(sub.boardsize).mean()
        den = sub.elo.pow(2).groupby(sub.boardsize).mean()
        for seen_b, v in (num / den).items():
            rows.append({"predicted": b, "seen": seen_b, "rv": float(v)})
    return pd.DataFrame(rows)


def train_test(ags):
    """Train-compute against test-compute iso-Elo frontiers: for each Elo
    level, the cheapest (train_flops, test_flops) pairs reaching it (needs
    pandas)."""
    pd = runs.require_pandas()
    df = ags.copy()
    df = df[df.samples > 0]
    df["test_flops"] = df.test_nodes * (df.train_flops / df.samples)
    df["train_flops_group"] = 10 ** np.log10(df.train_flops).round(1)

    frontiers = {}
    for e in np.linspace(-1500, 0, 7):
        sub = df[ELO * df.elo > e]
        if len(sub) == 0:
            continue
        frontiers[e] = sub.groupby("train_flops_group").test_flops.min().expanding().min()
    if not frontiers:
        return pd.DataFrame(columns=["train_flops", "elo", "test_flops"])
    frontiers = pd.concat(frontiers).unstack().T
    frontiers = 10 ** np.log10(frontiers).round(1)
    # drop the flat tail where the frontier has stopped improving
    frontiers = frontiers.where(frontiers.eq(frontiers.iloc[-1], axis=1).cumsum().le(1))
    out = frontiers.stack().reset_index()
    out.columns = ["train_flops", "elo", "test_flops"]
    return out.sort_values("train_flops")


def train_test_model(frontiers):
    """log10(test) ~ log10(train) + elo by least squares (needs pandas)."""
    pd = runs.require_pandas()
    f = frontiers.dropna().copy()
    X = np.stack([np.ones(len(f)), np.log10(f.train_flops.values), f.elo.values], axis=1)
    y = np.log10(f.test_flops.values)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    f["test_flops_hat"] = 10 ** (X @ coef)
    return f, pd.Series(coef, index=["intercept", "log10_train", "elo"])


def sample_calibrations(pseudocount=1):
    """Beta-posterior bands on each boardsize's best win rate against MoHex
    (needs pandas)."""
    import scipy.stats

    pd = runs.require_pandas()
    trials = sql.mohex_trial_query().frame()
    ags = sql.agent_query().frame()
    empty = pd.DataFrame(columns=["boardsize", "wins", "games", "winrate", "lower", "mid",
                                  "upper"])
    if len(trials) == 0 or len(ags) == 0:
        return empty
    rows = []
    for aid in set(trials.black_agent.dropna()) | set(trials.white_agent.dropna()):
        if aid not in ags.index:
            continue
        as_black = trials[trials.black_agent == aid]
        as_white = trials[trials.white_agent == aid]
        wins = as_black.black_wins.sum() + as_white.white_wins.sum()
        games = (as_black[["black_wins", "white_wins"]].to_numpy().sum()
                 + as_white[["black_wins", "white_wins"]].to_numpy().sum())
        rows.append({"boardsize": int(ags.loc[aid].boardsize), "wins": float(wins),
                     "games": float(games)})
    if not rows:
        return empty
    best = (
        pd.DataFrame(rows)
        .assign(winrate=lambda df: df.wins / df.games.clip(lower=1))
        .sort_values("winrate")
        .groupby("boardsize")
        .last()
        .reset_index()
    )
    dist = scipy.stats.beta(best.wins + pseudocount, best.games - best.wins + pseudocount)
    best["lower"] = dist.ppf(0.1)
    best["mid"] = dist.ppf(0.5)
    best["upper"] = dist.ppf(0.9)
    return best
