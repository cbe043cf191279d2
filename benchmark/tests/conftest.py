"""The benchmark's tests run on the CPU at small sizes (`tiny`); the ones
that need a card are marked `gpu` and skip inside the test without one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import spec  # noqa: E402
from benchmark.reference import nets  # noqa: E402

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def shrink(cell):
    """The cell at a size a CPU test holds: its network's `tiny` size, 8 or
    9 nodes, at most 4 leaves a pass, and its loop's `tiny` envs and steps;
    its kind, traffic mix and limits as they are."""
    cell.config = nets.module(cell.config).tiny(cell.config)
    K = min(cell.config["leaves_per_pass"], 4)
    cell.config.update(n_nodes=9 if K > 1 else 8, leaves_per_pass=K)
    cell.kind().tiny(cell)
    return cell


def tiny(name):
    return shrink(spec.cell(name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
