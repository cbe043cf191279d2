"""The five row kernels of the PyTorch/CUDA port under each lane layout, on
one GPU: the measurements `kernels.row_layout`'s rule is chosen by.

    python3 scripts/torch_row_layout.py [--envs 32768] [--sweep-envs 8192]
        [--boards 3 5 6 7 9 11] [--seed 0]

On the trees of `chip_smoke.py` (a 9x9 tree after 5 grow passes at
(B,T,A) = (envs, 65, 81), a 9x9 tree after 5 scan passes, a 6x6 K=1 tree
after 30 sims at (envs, 64, 36)) it times `node_actions` (all rows and the
tree.sim live rows), `node_actions_multi`, `descend`, `solve_probs` and
`sample_children_multi` under every lane-group width G (8, 16) that holds
the row (`kernels.row_layout` forced to G), with CUDA events, in turns.

Then, for each board of --boards, a K=1 tree of --sweep-envs envs after 20
sims of a random 64x2 model, on which `node_actions` (16 Newton steps, one
draw) and `node_actions_multi` (6 accelerated steps, 8 draws) are timed at
each G. Prints the card line and one JSON line of all times (ms).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from boardlaw_tpu_torch.mcts import kernels  # noqa: E402
from chip_smoke import time_ms  # noqa: E402

GROUPS = (8, 16)
RULE = kernels.row_layout  # the layout the wrappers use


def with_group(G):
    """Force the row kernels' lane-group width to G (None: the rule)."""
    kernels.row_layout = RULE if G is None else (lambda A: (G, -(-A // G)))


def groups_for(A):
    return [G for G in GROUPS if A <= G * kernels.ROW_MAX_J]


def in_turns(fns, reps=20):
    """Median ms of each named call, timed in the order given, then again in
    reverse; each name's two medians are averaged."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(list(fns))):
        times[name].append(time_ms(fns[name], reps))
    return {name: sum(t) / len(t) for name, t in times.items()}


def variants(make_call, A):
    """name -> call: the kernel at each G that holds rows of A actions."""
    fns = {}
    for G in groups_for(A):
        def call(G=G):
            with_group(G)
            make_call()
        fns[f"G={G}"] = call
    return fns


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=32 * 1024)
    parser.add_argument("--sweep-envs", type=int, default=8 * 1024)
    parser.add_argument("--boards", type=int, nargs="*", default=[3, 5, 6, 7, 9, 11])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import search

    card = chip_smoke.card_line()
    print(card, flush=True)
    kernels.build(verbose=True)
    results = {}

    def record(name, fns):
        res = in_turns(fns)
        results[name] = res
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()), flush=True)

    cfg9 = train.make_config(9, 512, 4, n_envs=args.envs)
    model9 = train.build_model(cfg9, device="cuda",
                               generator=torch.Generator().manual_seed(args.seed))
    for label, cfg in (("9x9 grow", cfg9), ("9x9 scan", chip_smoke.scan_config(cfg9))):
        with_group(None)
        draws = Draws(args.seed + 1, "cuda")
        tree = chip_smoke.mid_search_tree(cfg, model9, draws, args.envs, passes=5)
        B, T, A = tree.logits.shape
        K = cfg.mcts_config().leaves_per_pass
        rands = draws.uniform((B, K, T))
        qb = search._q_bounds(tree)
        rows = (tree.logits, tree.n_edge, tree.w_edge)
        probs = kernels.solve_probs(*rows, tree.c_puct, qb)
        record(f"{label} node_actions_multi {(B, K, T, A)}",
               variants(lambda: kernels.node_actions_multi(*rows, tree.children, rands,
                                                           tree.c_puct, qb), A))
        record(f"{label} solve_probs {(B, T, A)}",
               variants(lambda: kernels.solve_probs(*rows, tree.c_puct, qb), A))
        record(f"{label} sample_children_multi {(B, K, T, A)}",
               variants(lambda: kernels.sample_children_multi(probs, tree.children, rands), A))
        del tree, rands, probs, rows
        torch.cuda.empty_cache()

    with_group(None)
    cfg6 = train.best_config(6, n_envs=args.envs)
    model6 = train.build_model(cfg6, device="cuda",
                               generator=torch.Generator().manual_seed(args.seed))
    draws = Draws(args.seed + 2, "cuda")
    tree = chip_smoke.k1_mid_search_tree(cfg6, model6, draws, sims=30)
    B, T, A = tree.logits.shape
    rands = draws.uniform((B, T))
    qb = search._q_bounds(tree)
    for R in (T, tree.sim):
        nargs = (tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R],
                 tree.children[:, :R], rands[:, :R].contiguous(), tree.c_puct, qb)
        record(f"6x6 node_actions {(B, R, A)}", variants(lambda: kernels.node_actions(*nargs), A))
    record(f"6x6 descend {(B, T, A)}", variants(lambda: kernels.descend(tree, rands), A))
    del tree
    torch.cuda.empty_cache()

    for boardsize in args.boards:
        with_group(None)  # the search that grows the tree runs the rule's layout
        cfg = train.make_config(boardsize, 64, 2, n_envs=args.sweep_envs, leaves_per_pass=1)
        model = train.build_model(cfg, device="cuda",
                                  generator=torch.Generator().manual_seed(args.seed + boardsize))
        draws = Draws(args.seed + boardsize, "cuda")
        tree = chip_smoke.k1_mid_search_tree(cfg, model, draws, 20)
        B, T, A = tree.logits.shape
        qb = search._q_bounds(tree)
        nargs = (tree.logits, tree.n_edge, tree.w_edge, tree.children, draws.uniform((B, T)),
                 tree.c_puct, qb)
        margs = (*nargs[:4], draws.uniform((B, 8, T)), tree.c_puct, qb)
        record(f"{boardsize}x{boardsize} node_actions {(B, T, A)}",
               variants(lambda: kernels.node_actions(*nargs), A))
        record(f"{boardsize}x{boardsize} node_actions_multi {(B, 8, T, A)}",
               variants(lambda: kernels.node_actions_multi(*margs), A))
        del tree
        torch.cuda.empty_cache()
    with_group(None)
    print(card, flush=True)
    print(json.dumps({"card": card, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
