"""Scheduler: mark dead jobs, first-fit allocate fresh jobs, fetch outputs.
Counterpart of boardlaw_tpu/fleet/manage.py, making the same decisions.

`refresh` is one scheduling pass: every active job whose machine says it is
not alive is marked dead, then every fresh job, in registry order, goes to
the first machine (in name order) with enough free cards. `fetch` pulls the
outputs of active and dead jobs back, `cleanup` removes dead jobs' payloads
and records, `tails` reads each job's log.
"""
from __future__ import annotations

from logging import getLogger

from . import jobs as jobs_mod
from . import machines as machines_mod

log = getLogger(__name__)


def _allocate(machine, js, need):
    total = machine.resources.get("devices", 0)
    if isinstance(total, list):
        pool = list(total)
    else:
        pool = list(range(total))
    taken = set()
    for j in js.values():
        if j.status == "active" and j.machine == machine.name:
            taken.update(j.allocation.get("devices", []))
    free = [d for d in pool if d not in taken]
    if len(free) < need:
        return None
    return {"devices": free[:need]}


def refresh():
    """One scheduling pass."""
    ms = machines_mod.machines()
    with jobs_mod.lock():
        js = jobs_mod.jobs()

        # dead-job detection
        for j in js.values():
            if j.status != "active":
                continue
            m = ms.get(j.machine)
            if m is None or not m.alive(j):
                log.info(f"job {j.name} is dead")
                j.status = "dead"

        # first-fit allocation
        for j in js.values():
            if j.status != "fresh":
                continue
            need = int(j.resources.get("devices", 1))
            for name, m in ms.items():
                alloc = _allocate(m, js, need)
                if alloc is None:
                    continue
                try:
                    pid = m.launch(j, alloc)
                except Exception as e:
                    log.warning(f"launch of {j.name} on {name} failed: {e}")
                    continue
                j.status = "active"
                j.machine = name
                j.allocation = alloc
                j.pid = pid
                log.info(f"launched {j.name} on {name} (pid {pid})")
                break

        jobs_mod.save(js)
    return jobs_mod.jobs()


def fetch(target="output"):
    """Pull outputs of active and dead jobs back."""
    ms = machines_mod.machines()
    for j in jobs_mod.jobs().values():
        if j.status in ("active", "dead") and j.machine in ms:
            ms[j.machine].fetch(j, target)


def cleanup():
    """Remove dead jobs' payloads and registry entries."""
    ms = machines_mod.machines()
    for name, j in list(jobs_mod.jobs().items()):
        if j.status == "dead":
            if j.machine in ms:
                ms[j.machine].cleanup(j)
            jobs_mod.delete(name)


def tails(n=20):
    ms = machines_mod.machines()
    out = {}
    for j in jobs_mod.jobs().values():
        if j.machine in ms:
            out[j.name] = ms[j.machine].tail(j, n)
    return out
