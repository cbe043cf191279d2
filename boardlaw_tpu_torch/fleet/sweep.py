"""Sweeps: launch a width x depth grid of training runs as fleet jobs.
Counterpart of boardlaw_tpu/fleet/sweep.py.

`launch_grid` submits one job a (width, depth) that the sweep has not
submitted yet, each needing one card; `run` is the refresh/fetch loop that
ends when every job is dead. Jobs run `python -m boardlaw_tpu_torch.fleet.worker`,
which calls `train.run` with the job's params on the job's card.
"""
from __future__ import annotations

import time
from logging import getLogger

from . import jobs, manage

log = getLogger(__name__)

COMMAND = "python -m boardlaw_tpu_torch.fleet.worker"


def acknowledged(desc):
    """Params of jobs already submitted for this sweep."""
    return [
        j.params
        for j in jobs.jobs().values()
        if j.params.get("desc", "").startswith(desc)
    ]


def launch_grid(boardsize, widths, depths, desc="main", **kwargs):
    """Submit one job per (width, depth) not already acknowledged; returns the
    new jobs' names."""
    seen = acknowledged(desc)
    names = []
    for width in widths:
        for depth in depths:
            params = {
                "boardsize": boardsize,
                "width": width,
                "depth": depth,
                "desc": f"{desc}/{boardsize}",
                **kwargs,
            }
            if any(all(p.get(k) == v for k, v in params.items()) for p in seen):
                continue
            names.append(
                jobs.submit(COMMAND, resources={"devices": 1}, params=params)
            )
    return names


def run(interval=15, fetch_every=900):
    """The monitoring loop: a scheduling pass every `interval` seconds, the
    outputs fetched every `fetch_every`, until every job is dead."""
    last_fetch = 0.0
    while True:
        try:
            js = manage.refresh()
            states = {}
            for j in js.values():
                states[j.status] = states.get(j.status, 0) + 1
            log.info(f"fleet: {states}")
            if time.time() - last_fetch > fetch_every:
                manage.fetch()
                manage.cleanup()
                last_fetch = time.time()
            if all(j.status == "dead" for j in js.values()) and js:
                manage.fetch()
                break
        except Exception as e:
            log.warning(f"refresh error: {e}")
        time.sleep(interval)
