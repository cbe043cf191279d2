"""Experiment tracking: run registry, file registry, stats time-series,
checkpoints, logs. Counterpart of boardlaw_tpu/pavlov/, in the same on-disk
layout, so each package reads the other's runs.

Every run owns a directory `ROOT/<run-name>/` with an `_info.json` metadata
record; every file in it is registered with provenance; stats are
append-only structured-array time-series whose kind (mean/rate/cumsum/...)
fixes their resampling at read time; checkpoints are atomic-rename writes.
The writers need torch, numpy and the standard library only; the dataframe
readers import pandas when called.
"""
from . import runs, files, storage, stats, logs  # noqa: F401
