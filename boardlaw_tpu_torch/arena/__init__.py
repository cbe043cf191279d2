"""Evaluation: head-to-head matches, leagues, the live arena and the exact
small-board oracle. Counterpart of boardlaw_tpu/arena/."""
from . import common, neural, live  # noqa: F401
from .common import evaluate  # noqa: F401
