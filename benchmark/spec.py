"""A cell of BENCHMARK.json and the files it names: its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`, whose
"kind" names the loop in `kinds/` that drives it), its limits
(`limits/<workload>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`, each with `read(ctx)`). Everything is found by the
names in BENCHMARK.json, so a cell, a mix or a metric is added as files."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list

    def kind(self):
        """The module that drives this cell's traffic."""
        return importlib.import_module(f"benchmark.kinds.{self.traffic['kind']}")

    @staticmethod
    def reader(metric):
        """`read(ctx)` of a per-layer metric, from `metrics/<metric>.py`."""
        path = HERE / "metrics" / f"{metric}.py"
        s = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        return mod.read


def cell(workload):
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config_name=w["config"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
