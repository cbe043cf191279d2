"""Elo-inflation check: do the ratings of agents drift between a solve on
the early trials and one on all of them? Counterpart of
boardlaw_tpu/scaling/inflation.py. Returns a DataFrame (needs pandas); the
solves run on `device`, the card unless the caller asks for another."""
from __future__ import annotations

from .. import sql
from ..pavlov import runs
from .data import trial_elos_of


def inflation(boardsize, split=0.5, device=None):
    """(early, late, drift) per agent of the early trials, indexed by agent
    id."""
    pd = runs.require_pandas()
    trials = sql.trial_query(boardsize)
    if len(trials) < 4:
        return pd.DataFrame(columns=["early", "late", "drift"])
    cut = int(len(trials) * split)
    early = trial_elos_of(trials.take(slice(0, cut)), device)
    late = trial_elos_of(trials, device).reindex(early.index)

    out = pd.DataFrame({"early": early, "late": late})
    out["drift"] = out.late - out.early
    return out.dropna()
