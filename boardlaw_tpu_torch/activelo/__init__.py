"""Variational-Bayes Elo and active matchmaking. Counterpart of
boardlaw_tpu/activelo/."""
from .solvers import solve, Solution  # noqa: F401
from .suggestions import improvement, suggest  # noqa: F401
