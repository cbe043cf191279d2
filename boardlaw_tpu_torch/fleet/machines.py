"""Machine registry: `.fleet/machines/*.json` plugin-loaded machine specs.
Counterpart of boardlaw_tpu/fleet/machines.py, in the same format.

Each spec names a `type`, the module of this package that runs its jobs
(`local`, `ssh`); its resources are named pools (here `devices`: a count of
cards, or a list of card indices). A machine can be `forbid`den to drain it.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field

from . import jobs


@dataclass
class MachineSpec:
    name: str
    type: str
    resources: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    forbidden: bool = False


def machine_dir():
    d = jobs.root() / "machines"
    d.mkdir(parents=True, exist_ok=True)
    return d


def add(name, type, resources, **config):
    spec = {"name": name, "type": type, "resources": resources, "config": config}
    (machine_dir() / f"{name}.json").write_text(json.dumps(spec, indent=2))


def forbid(name, value=True):
    p = machine_dir() / f"{name}.json"
    spec = json.loads(p.read_text())
    spec["forbidden"] = value
    p.write_text(json.dumps(spec, indent=2))


def specs():
    out = {}
    for p in sorted(machine_dir().glob("*.json")):
        raw = json.loads(p.read_text())
        out[raw["name"]] = MachineSpec(**raw)
    return out


def load(spec: MachineSpec):
    """The plugin Machine for a spec, from this package's module of its type."""
    module = importlib.import_module(f".{spec.type}", __package__)
    return module.Machine(spec)


def machines():
    return {name: load(spec) for name, spec in specs().items() if not spec.forbidden}
