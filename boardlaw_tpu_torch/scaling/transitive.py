"""Transitivity check: do the head-to-head results respect the solved
ratings? Counterpart of boardlaw_tpu/scaling/transitive.py: each pair's
empirical win rate against the one its Elo gap implies. Returns pandas
(needs pandas); the solve runs on `device`, the card unless the caller asks
for another."""
from __future__ import annotations

import numpy as np

from .. import elos, sql
from ..pavlov import runs


def residuals(boardsize, device=None):
    """Empirical minus implied win rate per (black, white) agent pair, NaN
    where a pair played no games."""
    pd = runs.require_pandas()
    trials = sql.trial_query(boardsize)
    if len(trials) == 0:
        return pd.DataFrame()
    ws, gs, ids = sql.trial_matrices(trials)
    r = elos.solve(ws, gs, device=device)
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = ws / gs
    implied = 1 / (1 + np.exp(-(r[:, None] - r[None, :])))
    idx = pd.Index(ids, name="black_agent")
    cols = pd.Index(ids, name="white_agent")
    return pd.DataFrame(np.where(gs > 0, rates - implied, np.nan), idx, cols)


def worst_triangles(boardsize, k=10, device=None):
    res = residuals(boardsize, device)
    if res.empty:
        return runs.require_pandas().Series(dtype=float)
    return res.abs().stack().sort_values(ascending=False).head(k)
