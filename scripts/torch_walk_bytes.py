"""The bytes each walk of a 9x9 K=8 search moves, counted pass by pass on a
real search of the PyTorch/CUDA port, and on a card each design's time.

    python3 scripts/torch_walk_bytes.py [--envs 2048] [--scale-to 32768]
        [--device cpu|cuda] [--scan] [--seed 0]

Runs one `make_config(9, 512, 4)` search (grow passes; with --scan, scan
passes over all 65 rows) with a random 512x4 model from `--seed` on worlds
mixed for 40 moves, takes the (K,B,R) rows each pass hands `walk`, and
prints per pass: the rows R and levels L, the levels the walks visit (from
`walk_ref`'s paths) and three byte counts, each with the (K*B, L+3) int32
outputs written once:

* useful: 9 bytes a visited level (acts, nxt, the child's terminal flag);
  the bound `chip_smoke.py` uses;
* block, gather, chase: what each design of csrc/walk.cu reads
  (`chip_smoke.walk_bytes`): every byte of each env's K acts and nxt rows
  and its terminal row; its terminal row and 2 whole 32-byte sectors a
  visited level; 3 sectors a visited level.

Counts are scaled from `--envs` to `--scale-to` envs (the path's 32,768).
They are counts, not times: the levels depend on the tree, not the device.
With `--device cuda` it also times each design of csrc/walk.cu on each
pass's inputs (`chip_smoke.device_ms`: the card's time a call, bit-equal to
the twin first) and prints the card's name and power limit.

With `--k1` (on the card) it times the public `kernels.walk` instead, at the
6x6 K=1 path's shapes: on `chip_smoke.py` phase 4's tree (`best_config(6)`,
30 sims, `--envs` envs, the (B,T) rows `node_actions` draws) and on depth-63
chains. `--package-root DIR` imports `boardlaw_tpu_torch` from another
checkout, so one call can time two trees' kernels on one card.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=2048)
    parser.add_argument("--scale-to", type=int, default=32 * 1024)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--scan", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--k1", action="store_true")
    parser.add_argument("--package-root", default=None)
    args = parser.parse_args(argv)
    if args.package_root is not None:
        sys.path.insert(0, os.path.abspath(args.package_root))
    if args.k1:
        return k1_walk_times(args)

    import torch

    import chip_smoke
    from boardlaw_tpu_torch import learning, train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.mcts import kernels, search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    cfg = train.make_config(9, 512, 4, n_envs=args.envs)
    mcfg = cfg.mcts_config()
    if args.scan:
        mcfg = replace(mcfg, grow_passes=False)
    model = train.build_model(cfg, device=args.device,
                              generator=torch.Generator().manual_seed(args.seed))
    draws = Draws(args.seed + 1, args.device)
    worlds = learning.mix(hex.Hex.initial(args.envs, 9, device=args.device), draws, 40)
    walk = kernels.walk
    seen = []

    def counting_walk(terminal, acts, nxt, max_levels=None):
        out = walk(terminal, acts, nxt, max_levels)
        seen.append((tuple(acts.shape), out[3].shape[1], int((out[3] >= 0).sum()),
                     (terminal, acts, nxt, max_levels)))
        return out

    kernels.walk = counting_walk
    try:
        with torch.no_grad():
            search.mcts(worlds, make_eval_fn(model), draws, mcfg)
    finally:
        kernels.walk = walk

    scale = args.scale_to / args.envs
    mode = "scan" if args.scan else "grow"
    print(f"9x9 {mode} search, {args.envs} envs on {args.device}, counts scaled to "
          f"{args.scale_to} envs (MB)")
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        print(chip_smoke.card_line())
    designs = list(kernels.WALK_DESIGNS) if on_card else []
    print("pass R L levels mean_depth useful_MB block_MB gather_MB chase_MB"
          + "".join(f" {d}_ms" for d in designs))
    totals = {}
    for p, ((K, B, R), L, levels, inputs) in enumerate(seen):
        times = ""
        if on_card:
            ref = kernels.walk_ref(*inputs)
            for d in designs:
                got = kernels._walk_launch(*inputs, d)
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise SystemExit(f"walk ({d!r}) differs from the twin at pass {p}")
                ms = chip_smoke.device_ms(lambda: kernels._walk_launch(*inputs, d), 20)
                times += f" {ms:.4f}"
        nbytes = chip_smoke.walk_bytes(levels, K, B, R, L)
        for k, v in nbytes.items():
            totals[k] = totals.get(k, 0.0) + v * scale
        print(f"{p} {R} {L} {int(levels * scale)} {levels / (K * B):.3f} "
              + " ".join(f"{v * scale / 1e6:.2f}" for v in nbytes.values()) + times)
    print("all passes: " + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in totals.items()))
    return 0


def k1_walk_times(args):
    """`--k1`: the public `walk` on the card at the 6x6 K=1 path's shapes."""
    import torch

    import chip_smoke
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels, search

    print(chip_smoke.card_line())
    cfg = train.best_config(6, n_envs=args.envs)
    model = train.build_model(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(args.seed))
    draws = Draws(args.seed + 2, "cuda")
    tree = chip_smoke.k1_mid_search_tree(cfg, model, draws, 30)
    B, T = tree.parents.shape
    acts, nxt = kernels.node_actions(tree.logits, tree.n_edge, tree.w_edge, tree.children,
                                     draws.uniform((B, T)), tree.c_puct, search._q_bounds(tree))
    chain = torch.arange(1, T + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
    chain[:, -1] = -1
    for label, term, n in (("6x6 K=1 tree", tree.terminal, nxt),
                           (f"depth-{T - 1} chains", torch.zeros_like(tree.terminal), chain)):
        ref = kernels.walk_ref(term, acts, n, T)
        out = kernels.walk(term, acts, n, T)
        if not all(torch.equal(o, r) for o, r in zip(out, ref)):
            raise SystemExit(f"{label}: walk differs from the twin")
        dm, cm = chip_smoke.both_ms(lambda: kernels.walk(term, acts, n, T), 20)
        print(f"{label}, (B,T)=({B},{T}), {int((ref[3] >= 0).sum())} levels: walk of "
              f"{os.path.relpath(kernels.__file__)} {dm:.4f} ms on the card, {cm:.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
