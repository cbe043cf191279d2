"""The benchmark's tests run on the CPU at small sizes (`tiny`); the ones
that need a card are marked `gpu` and skip inside the test without one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import spec  # noqa: E402

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny(name):
    """The cell at a size a CPU test holds: a 16-wide net, 8 or 9 nodes, a
    few envs and steps; its kind, traffic mix and limits as they are."""
    cell = spec.cell(name)
    cfg, traffic = cell.config, cell.traffic
    K = min(cfg["leaves_per_pass"], 4)
    cfg.update(width=16, n_nodes=9 if K > 1 else 8, leaves_per_pass=K)
    if traffic["kind"] == "selfplay":
        cfg.update(n_envs=32, buffer_len=4, mix_steps=20)
        traffic.update(mix_sample=8, timed_steps=2, profiled_steps=1)
    else:
        traffic.update(n_envs=16, check_plies=3, timed_plies=2, profiled_plies=3,
                       search=dict(traffic["search"], leaves_per_pass=K))
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
