"""Active matchmaking: which pair gains the most rating information?
Counterpart of boardlaw_tpu/activelo/suggestions.py.

The expected information gain of one more game between a pair is
sigma_d^2 / (1/e + 2 + e) with e = exp(-mu_d), a rank-1 information-update
heuristic.
"""
from __future__ import annotations

import numpy as np

from ..elos import _is_frame


def improvement(soln):
    """The gain matrix: a DataFrame for a pandas solution, else numpy."""
    if _is_frame(soln.mud):
        e = np.exp(-soln.mud)
        return soln.sigmad ** 2 * (1 / (1 / e + 2 + e))
    e = np.exp(-np.asarray(soln.mud))
    return np.asarray(soln.sigmad) ** 2 / (1 / e + 2 + e)


def suggest(soln):
    """The (row, col) pair with the highest expected information gain: names
    where the solution has them, else indices."""
    imp = np.asarray(improvement(soln))
    row, col = np.unravel_index(np.nanargmax(imp), imp.shape)
    if soln.names is not None:
        return soln.names[row], soln.names[col]
    return row, col
