"""The frozen work arithmetic against the port's shapes and chip_smoke.py's
byte counts."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import spec, work


def _chip_smoke():
    path = Path(spec.ROOT) / "chip_smoke.py"
    s = importlib.util.spec_from_file_location("chip_smoke_for_bench", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_weights_of_the_9x9_agent():
    from boardlaw_tpu_torch import train

    cfg = spec.cell("hex9_512x4.selfplay").config
    assert work.macs(cfg) == 1_176_146
    model = train.build_model(train.best_config(9), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == 1_176_150 and work.macs(cfg) == n - cfg["depth"]


@pytest.mark.parametrize("boardsize", [3, 5, 6, 7, 9])
def test_weights_are_the_ports_parameters_less_rezero(boardsize):
    from boardlaw_tpu_torch import train

    tcfg = train.best_config(boardsize)
    model = train.build_model(tcfg, device="cpu")
    cfg = {"boardsize": boardsize, "width": tcfg.width, "depth": tcfg.depth}
    assert work.macs(cfg) == sum(p.numel() for p in model.parameters()) - tcfg.depth


@pytest.mark.parametrize("cell", ["hex9_512x4.selfplay", "hex9_512x4_bf16.selfplay"])
def test_last_grow_pass_bytes_are_chip_smokes(cell):
    cs = _chip_smoke()
    cfg = spec.cell(cell).config
    K, B, R, A = 8, 32768, 65, 81
    tree = SimpleNamespace(logits=torch.zeros(1, dtype=getattr(torch, cfg["tree_dtype"])),
                           n_edge=torch.zeros(1, dtype=torch.bfloat16),
                           children=torch.zeros((1, A), dtype=torch.int8))
    theirs = (B * R * (A * cs.row_bytes(tree) + cs.child_bytes(tree, K)) + B * K * R * 4 + B * 4
              + 8 + 2 * B * K * R * 4)
    one = {"leaves_per_pass": K, "n_nodes": R, "boardsize": 9, "tree_dtype": cfg["tree_dtype"]}
    last = work.search_bytes(one, B) - work.search_bytes(dict(one, n_nodes=R - K), B)
    assert last == theirs
    assert work.node_actions_bytes(B, R, A, K, T=65,
                                   logit_bytes=tree.logits.element_size()) == theirs
    assert cs.HBM_BYTES_PER_S == work.HBM_BYTES_PER_S and cs.F32_FLOPS == work.PEAK_FLOPS["float32"]


def test_pass_shapes_are_the_searchs():
    from boardlaw_tpu_torch.mcts.search import MCTSConfig, pass_shape, tree_size

    for n, K in ((64, 8), (512, 8), (64, 4), (9, 4)):
        cfg = MCTSConfig(n_nodes=n, leaves_per_pass=K, grow_passes=True)
        assert work.tree_size(n, K) == tree_size(cfg)
        assert work.n_passes(n, K) == cfg.n_passes
        assert all(work.pass_shape(n, K, p) == pass_shape(cfg, p) for p in range(cfg.n_passes))


def test_step_flops():
    c9 = spec.cell("hex9_512x4.selfplay").config
    c6 = spec.cell("hex6_128x1.selfplay").config
    assert work.evaluations(c9) == 65 and work.evaluations(c6) == 64
    assert work.train_step_flops(c9) == 1_176_146 * 32768 * (2 * 65 + 6)
    # the K=1 search's calls cover each simulation's live rows
    assert work.search_calls(c6) == [(i, 1) for i in range(1, 64)]
    assert [r for r, _ in work.search_calls(c9)] == [9, 17, 25, 33, 41, 49, 57, 65]
