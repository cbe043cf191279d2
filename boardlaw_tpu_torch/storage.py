"""Snapshot schedulers: log-spaced FLOP or wall-clock savepoints.
Counterpart of boardlaw_tpu/storage.py.

Snapshots are taken at 21 log-spaced cumulative-FLOP budgets per boardsize
(`BOUNDS`) or log-spaced wall-clock times (`TIMES`), with a throttled
`latest` for the live arena; a run ends at its boardsize's sample budget
(`SAMPLES`). The storer is handed the state dict every step; it only
references the live tensors, and the host copy is made when a file is
written (`pavlov.storage`).
"""
from __future__ import annotations

import time
from logging import getLogger

import numpy as np
import torch

from .pavlov import stats, storage as pstorage

log = getLogger(__name__)

# Per-boardsize cumulative-FLOP snapshot bounds (reference storage.py:12-19)
BOUNDS = {
    3: (1e10, 5e11),
    4: (1e10, 1e13),
    5: (1e11, 3e13),
    6: (1e11, 4e14),
    7: (1e11, 1e16),
    8: (1e11, 3e16),
    9: (1e12, 1e17),
}

TIMES = {3: 60, 4: 120, 5: 300, 6: 900, 7: 3600, 8: 7200, 9: 14400}

# Per-boardsize sample budgets ending a run (reference storage.py:24-33)
SAMPLES = {
    3: 1e8,
    4: 2e8,
    5: 3e8,
    6: 6e8,
    7: 1e9,
    8: 1.5e9,
    9: 2e9,
}


def _leaves(tree):
    """The array leaves of a parameter tree: a module's parameters, or the
    values of nested dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def flops_per_sample(params, n_nodes):
    """Estimated forward FLOPs per training sample: n_nodes net evals, each
    costing one multiply-add per weight plus one add per bias, the 0-d
    parameters (the ReZero alphas) not counted. `params` is a model, a state
    dict, or any nested dicts/lists of tensors or arrays. A model that
    counts its own multiply-adds (`macs()`: `networks.AZTower`, whose
    convolutions take each weight at every output position and whose batch
    norm statistics are buffers) is counted by them."""
    if hasattr(params, "macs"):
        return n_nodes * params.macs()
    count = 0
    for p in _leaves(params):
        if np.ndim(p) >= 1:
            count += int(np.prod(np.shape(p)))
    return n_nodes * count


def flops_savepoints(boardsize, n_snapshots=21, upper=None):
    lower = BOUNDS[boardsize][0]
    upper = upper or BOUNDS[boardsize][1]
    return 10 ** np.linspace(np.log10(lower), np.log10(upper), n_snapshots)


def time_savepoints(boardsize, n_snapshots=21):
    return 10 ** np.linspace(0, np.log10(TIMES[boardsize]), n_snapshots)


class Storer:
    """Common machinery: counts samples/FLOPs, writes numbered snapshots at
    savepoints and a 60s-throttled `latest`, reports progress, and signals
    when the run's budget is exhausted."""

    def __init__(self, run, boardsize, flops_per, samples_bound=None, latest_throttle=60):
        self.run = run
        self.boardsize = boardsize
        self.flops_per = flops_per
        self.samples_bound = samples_bound or SAMPLES.get(boardsize, float("inf"))
        self.latest_throttle = latest_throttle
        self.next_point = 0
        self.n_samples = 0
        self.n_flops = 0
        self.start = None
        self._last_report = time.time()

    def payload(self, state_dict):
        return {
            "agent": state_dict,
            "n_flops": float(self.n_flops),
            "n_samples": float(self.n_samples),
            "runtime": time.time() - (self.start or time.time()),
        }

    _payload = payload

    def _report(self, target_desc):
        if time.time() > self._last_report + 60:
            self._last_report = time.time()
            log.info(
                f"{self.n_samples:.3g} samples, {self.n_flops:.3g} FLOPs; {target_desc}"
            )

    def step(self, state_dict, n_samples):
        raise NotImplementedError

    def _snapshot(self, payload):
        """Write a numbered snapshot; its seconds go to `time.save.snapshot`."""
        t0 = time.perf_counter()
        pstorage.save_snapshot(self.run, payload, n_flops=self.n_flops, n_samples=self.n_samples)
        stats.mean("time.save.snapshot", time.perf_counter() - t0)

    def _latest(self, payload):
        """The throttled `latest`; the seconds of a write go to
        `time.save.latest`."""
        t0 = time.perf_counter()
        if pstorage.throttled_latest(self.run, payload, self.latest_throttle):
            stats.mean("time.save.latest", time.perf_counter() - t0)

    def seed(self, n_flops, n_samples, runtime=0.0):
        """Continue counting from a resumed run's checkpoint payload: restore
        the cumulative counters and advance past savepoints already taken."""
        self.n_flops = float(n_flops)
        self.n_samples = float(n_samples)
        self._seed_runtime(runtime)
        self._advance()

    def _seed_runtime(self, runtime):
        pass

    def _advance(self):
        raise NotImplementedError


class FlopsStorer(Storer):
    """Snapshot at log-spaced cumulative-FLOP budgets
    (reference storage.py:56-120)."""

    def __init__(self, run, boardsize, flops_per, **kwargs):
        super().__init__(run, boardsize, flops_per, **kwargs)
        self.savepoints = flops_savepoints(boardsize)
        self.start = time.time()

    def step(self, state_dict, n_samples):
        self.n_samples += n_samples
        self.n_flops += self.flops_per * n_samples
        payload = self._payload(state_dict)
        if self.next_point < len(self.savepoints) and self.n_flops >= self.savepoints[self.next_point]:
            log.info(f"Taking a snapshot at {self.n_flops:.3g} FLOPs")
            self._snapshot(payload)
            self.next_point += 1
        self._latest(payload)
        self._report(f"snapshot {self.next_point}/{len(self.savepoints)}")
        return (self.next_point >= len(self.savepoints)) or (
            self.n_samples > self.samples_bound
        )

    def _advance(self):
        while (
            self.next_point < len(self.savepoints)
            and self.n_flops >= self.savepoints[self.next_point]
        ):
            self.next_point += 1


class TimeStorer(Storer):
    """Snapshot at log-spaced wall-clock times; the timer starts at the first
    step so compile/warmup doesn't count (reference storage.py:125-164)."""

    def __init__(self, run, boardsize, flops_per, **kwargs):
        super().__init__(run, boardsize, flops_per, **kwargs)
        self.savepoints = time_savepoints(boardsize)

    def step(self, state_dict, n_samples):
        if self.start is None:
            self.start = time.time()
        self.n_samples += n_samples
        self.n_flops += self.flops_per * n_samples
        payload = self._payload(state_dict)
        elapsed = time.time() - self.start
        if self.next_point < len(self.savepoints) and elapsed >= self.savepoints[self.next_point]:
            self._snapshot(payload)
            self.next_point += 1
        self._latest(payload)
        self._report(f"snapshot {self.next_point}/{len(self.savepoints)}")
        return self.next_point >= len(self.savepoints)

    def _seed_runtime(self, runtime):
        # backdate the clock so elapsed time continues from the old run
        self.start = time.time() - float(runtime)

    def _advance(self):
        elapsed = time.time() - self.start if self.start is not None else 0.0
        while (
            self.next_point < len(self.savepoints)
            and elapsed >= self.savepoints[self.next_point]
        ):
            self.next_point += 1
