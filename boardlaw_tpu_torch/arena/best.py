"""Targeted evaluation of each boardsize's top agent: more games against the
challengers whose rating gap to it is still uncertain. Counterpart of
boardlaw_tpu/arena/best.py.

The trials come from the results database as `sql.Rows`, and the ratings
from `elos.solve` on their numpy matrices (agent ids in numeric order, as
the JAX package's frames are indexed), so the card's machine, which has no
pandas, runs it. `frontier_participants` reads an agents DataFrame (needs
pandas), as in the JAX package.
"""
from __future__ import annotations

from logging import getLogger

import numpy as np
import scipy.special

from .. import elos, sql
from ..draws import Draws
from ..utils import resolve_device
from . import common

log = getLogger(__name__)


def frontier_participants(ags, boardsize):
    """Agents on (or bracketing) the compute frontier of a boardsize, from
    an agents DataFrame with `train_flops`, `run` and `elo` columns."""
    from ..scaling import data

    ags = ags.loc[lambda df: df.boardsize == boardsize]
    if len(ags) == 0:
        return []
    ys = data.interp_curves(ags)

    selection = []
    for flops, r in ys.iterrows():
        run = r.idxmax()
        snaps = ags.loc[ags.run == run].sort_values("train_flops")
        dists = np.log10(snaps.train_flops) - np.log10(flops)
        if (dists == 0).any():
            selection.append((dists == 0).idxmax())
        else:
            if (dists < 0).any():
                selection.append(dists[dists < 0].index[-1])
            if (dists > 0).any():
                selection.append(dists[dists > 0].index[0])
    return list(set(selection))


def _ratings(trials, device=None):
    """(ids, ratings, wins, games) of a boardsize's trials."""
    ws, gs, ids = sql.trial_matrices(trials)
    return ids, elos.solve(ws, gs, device=device), ws, gs


def top_agent(boardsize, device=None):
    """The highest-rated agent id of a boardsize from the current trials;
    None where there are none."""
    trials = sql.trial_query(boardsize)
    if len(trials) == 0:
        return None
    ids, r, _, _ = _ratings(trials, device)
    return ids[int(np.argmax(r))]


def rating_std(wins, losses):
    """Beta-posterior std of the log-odds rating gap."""
    m, n = wins, losses
    return (scipy.special.polygamma(1, m + 1) + scipy.special.polygamma(1, n + 1)) ** 0.5


def std_available(boardsize, max_std=0.5, max_games=512 * 1024, device=None):
    """Challengers whose rating gap to the top agent is still too
    uncertain: `sql.Rows` of (agent, std, games), the largest std first."""
    columns = ["agent", "std", "games"]
    trials = sql.trial_query(boardsize)
    if len(trials) == 0:
        return sql.Rows(columns)
    ids, r, ws, gs = _ratings(trials, device)
    top = int(np.argmax(r))
    rows = []
    for i, a in enumerate(ids):
        if i == top:
            continue
        w = 0.0 if np.isnan(ws[top, i]) else float(ws[top, i])
        g = float(gs[top, i])
        std = float(rating_std(w, g - w))
        if std > max_std and g < max_games:
            rows.append((a, std, g))
    rows.sort(key=lambda x: -x[1])
    return sql.Rows(columns, rows)


def evaluate(boardsize, n_envs=64, rounds=8, seed=0, draws=None, device=None):
    """Play the most uncertain challenger against the top agent, one round
    of `n_envs` games a time, until the std rule holds or `rounds` are
    played; each round's trials go to the database. Each round's games take
    `draws.split()` (default `Draws(seed)`), where the JAX package keys a
    round with `PRNGKey(seed + round)`."""
    device = resolve_device(device)
    draws = draws if draws is not None else Draws(seed, device)
    for rnd in range(rounds):
        avail = std_available(boardsize, device=device)
        if len(avail) == 0:
            break
        top = top_agent(boardsize, device=device)
        challenger = int(avail.agent[0])
        top_ag = common.sql_agent(top, device=device)
        ch_ag = common.sql_agent(challenger, device=device)
        world = common.sql_world(top, n_envs, device=device)
        results = common.evaluate(world, {str(top): top_ag, str(challenger): ch_ag},
                                  draws=draws.split())
        rows = []
        for r in results:
            black, white = r["names"]
            rows.append((int(black), int(white), r["wins"][0], r["wins"][1], r["moves"],
                         r["times"]))
        sql.save_trials(rows)
        log.info(f"best-eval round {rnd}: {top} vs {challenger}")
