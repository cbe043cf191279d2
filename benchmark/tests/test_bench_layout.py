"""BENCHMARK.json against the contract's shape, every cell resolved to its
files by name, and no module of the benchmark importing JAX or the JAX
package."""
import ast
import json
import re
from dataclasses import MISSING, fields
from pathlib import Path

import pytest

from benchmark import harness, spec
from benchmark.tests.conftest import WORKLOADS

HERE = Path(spec.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200
        # each cell a metric lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells)), m["name"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


# keys of a configuration file that document it; every other key is a field
# of the port's TrainConfig
DOC_KEYS = {"source", "as_run_by", "precision", "assumed", "reduced"}
# the search's and the replay's routes: a configuration runs the ones the
# port's entry point picks
ROUTES = ("buffer_dtype", "solve_iters", "solve_accel", "backup_mode", "warm_solve", "sample_cum",
          "solve_kernel", "sample_kernel")
CONFIGS = {c["name"]: c["file"] for c in spec.benchmark()["configs"]}


def unread(cfg):
    """Keys of a configuration that neither the port reads nor document it."""
    from boardlaw_tpu_torch import train

    return set(cfg) - {f.name for f in fields(train.TrainConfig)} - DOC_KEYS


def entry_config(cfg):
    """What the port's entry point trains for the configuration: a row of
    the paper's table (`best_config`) for a network of that table at a
    row's sizes, else `make_config` with the configuration's own sizes,
    search and precision, on the entry point's routes."""
    from boardlaw_tpu_torch import train

    sizes = [f.name for f in fields(train.TrainConfig) if f.default is MISSING]
    precision = {k: cfg[k] for k in ("dtype", "tree_dtype")}
    if cfg.get("net", "fc") == "fc" and cfg["boardsize"] in train.BEST:
        best = train.best_config(cfg["boardsize"], **precision)
        if all(getattr(best, k) == cfg[k] for k in sizes):
            return best
    own = {k: v for k, v in cfg.items()
           if k not in DOC_KEYS and k not in ROUTES and k not in sizes and k != "n_nodes"}
    return train.make_config(*(cfg[k] for k in sizes), nodes=cfg["n_nodes"], **own)


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_resolves_to_its_files(name):
    from benchmark.kinds.selfplay import program_config

    cell = spec.cell(name)
    assert cell.kind().run
    assert set(harness.check.limits(name))
    assert cell.per_layer and all(callable(cell.reader(m["name"])) for m in cell.per_layer)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    # the configuration is the one the port's entry point trains with, in
    # the precision it states
    assert program_config(cell.config) == entry_config(cell.config)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_key_of_a_configuration_is_the_ports_or_documents_it(name):
    cfg = json.loads((spec.ROOT / CONFIGS[name]).read_text())
    assert not unread(cfg)
    # a key the port lacks, which `program_config` would drop, fails
    assert unread(dict(cfg, no_such_field=1)) == {"no_such_field"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), path
    if "reference" in path.parts:
        assert "boardlaw_tpu_torch" not in tops, "the reference imports nothing of the program"


def test_nothing_reads_the_jax_benchmarks():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json"):
            assert name not in text, (path, name)
