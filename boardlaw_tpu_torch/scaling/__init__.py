"""Compute-scaling analysis. Counterpart of boardlaw_tpu/scaling/; `data`
and its DataFrame functions, the `inflation` and `transitive` checks and the
`paper` figures (matplotlib, imported where a figure is drawn)."""
from . import data, inflation, paper, transitive  # noqa: F401
