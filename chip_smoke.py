"""Smoke run of the PyTorch/CUDA port (boardlaw_tpu_torch) on one GPU.

    python3 chip_smoke.py [--envs 32768] [--steps 3] [--seed 0]

Phases, each a hard failure with a non-zero exit:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  2. build the two CUDA kernels from boardlaw_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     of the main path's last pass, on a real mid-search 9x9 tree: `walk` bit-exact,
     `node_actions_multi` draw for draw up to roundoff at CDF boundaries and
     its solved alpha to rtol 1e-5; median times of kernel and twin; a small
     search on the card held against the same search on the CPU (twins);
  4. the main path: `init_worlds` (mix), a random 512x4 FCModel, then
     `--steps` calls of `train.actor_record` at 9x9, 64 nodes, K=8 grow
     passes, prefix backup; both kernels' launch counts must rise by 8 per
     step, every root must hold 2*K*n_passes = 128 visits, the outputs must be
     finite and the root logits -inf exactly at invalid actions;
  5. a JSON line of kernel numbers, the card line, and the last line
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float operations per (node row, action lane) of node_actions_multi: q (4),
# exp, count, lambda*pi, the initial bound (3), 8 per solver step, probs (2),
# 7 prefix-sum adds and 2 compares per draw
def _solve_ops_per_lane(n_iters, K):
    return 10 + 8 * n_iters + 2 + 7 + 2 * K


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Median CUDA-event time of one call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fail(msg):
    raise SystemExit(f"FAILED: {msg}")


def shift_cumsum(probs):
    """The twin's log-shift inclusive prefix sum over the last axis."""
    import torch.nn.functional as F

    A = probs.shape[-1]
    cum, shift = probs, 1
    while shift < A:
        cum = cum + F.pad(cum, (shift, 0))[..., :A]
        shift *= 2
    return cum


def mid_search_tree(cfg, model, draws, n_envs, passes):
    """A real 9x9 tree after `passes` grow passes of the port's search."""
    from boardlaw_tpu_torch import learning
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    worlds = learning.mix(hex.Hex.initial(n_envs, cfg.boardsize, device="cuda"), draws, 40)
    mcfg = cfg.mcts_config()
    eval_fn = make_eval_fn(model)
    tree = search.build(worlds, mcfg)
    search.initialize(tree, eval_fn(worlds), draws, mcfg, worlds.valid)
    K = mcfg.leaves_per_pass
    T = tree.parents.shape[1]
    for p in range(passes):
        R = min(T, 1 + (p + 1) * K)
        search.simulate_multi(tree, eval_fn, draws.pass_rands(p, (K, n_envs, R)), mcfg,
                              rows=R, max_levels=p + 2)
    return tree


def check_node_actions(tree, cfg, draws, report):
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    mcfg = cfg.mcts_config()
    B, T, A = tree.logits.shape
    K = mcfg.leaves_per_pass
    rands = draws.uniform((B, K, T))
    args = (tree.logits, tree.n_edge, tree.w_edge, tree.children, rands, tree.c_puct,
            search._q_bounds(tree))
    kw = dict(n_iters=mcfg.solve_iters, accel=mcfg.solve_accel)
    ka, kc, kalpha = kernels.node_actions_multi(*args, return_alpha=True, **kw)
    ra, rc, ralpha = kernels.node_actions_multi_ref(*args, return_alpha=True, **kw)
    torch.cuda.synchronize()

    rel = ((kalpha - ralpha).abs() / ralpha.abs()).flatten()
    alpha_ok = float((rel <= 1e-5).float().mean())
    mism = (ka != ra)
    n_mism = int(mism.sum())
    frac_equal = 1.0 - n_mism / ka.numel()
    child_ok = bool(((kc == rc) | mism).all())
    # each mismatched draw: where does its rand sit against the twin's CDF,
    # and against the CDF of the kernel's own alpha?
    within_1e5 = within_cdfs = 0
    if n_mism:
        # both CDFs of the mismatched rows, from the twin's and the kernel's alpha
        b, k, t = mism.nonzero(as_tuple=True)
        q, counts = search._edge_q_counts(tree.n_edge[b, t], tree.w_edge[b, t], args[-1])
        N = counts.sum(-1)
        lampi = (tree.c_puct[b] * N / (N + A))[:, None] * torch.exp(tree.logits[b, t])
        cum_r = shift_cumsum(lampi / (ralpha[b, t][:, None] - q))
        cum_k = shift_cumsum(lampi / (kalpha[b, t][:, None] - q))
        r = rands[b, k, t][:, None]
        lane = torch.minimum(ka[b, k, t], ra[b, k, t]).long().clamp_min(0)[:, None]
        c_r = cum_r.gather(1, lane)
        c_k = cum_k.gather(1, lane)
        within_1e5 = int(((c_r - r).abs() <= 1e-5).sum())
        within_cdfs = int(((r >= torch.minimum(c_r, c_k) - 1e-5)
                           & (r <= torch.maximum(c_r, c_k) + 1e-5)).sum())
    print(f"node_actions_multi vs twin at (B,K,T,A)=({B},{K},{T},{A}): draws equal "
          f"{frac_equal:.8f} ({n_mism} differ; {within_1e5} within 1e-5 of the twin's CDF at "
          f"the boundary lane, {within_cdfs} between the twin's and the kernel's CDF there), "
          f"alpha within rtol 1e-5 on {alpha_ok:.8f} of rows (max rel {float(rel.max()):.3g}); "
          f"the solve's lane sums run in another order than the twin's, so exact equality "
          f"cannot be required", flush=True)
    if not child_ok:
        fail("node_actions_multi child pointers differ where the actions agree")
    if frac_equal < 0.9999:
        fail("node_actions_multi: fewer than 99.99% of draws equal the twin's")
    if within_cdfs != n_mism:
        fail("node_actions_multi: a mismatched draw is not explained by a CDF boundary")
    if alpha_ok < 0.9999 or float(rel.max()) > 1e-3:
        fail("node_actions_multi: alpha disagrees with the twin")

    k_ms = time_ms(lambda: kernels.node_actions_multi(*args, **kw), 20)
    r_ms = time_ms(lambda: kernels.node_actions_multi_ref(*args, **kw), 5)
    nbytes = (B * T * A * (4 + 2 + 4 + 1) + B * K * T * 4 + B * 4 + 8 + 2 * B * K * T * 4)
    ops = B * T * A * _solve_ops_per_lane(mcfg.solve_iters, K)
    report["node_actions_multi"] = dict(
        ms=k_ms, plain_ms=r_ms, max_abs_err=float((kalpha - ralpha).abs().max()),
        bytes=nbytes, ops=ops)
    print(f"node_actions_multi: kernel {k_ms:.4f} ms, twin {r_ms:.4f} ms (median); "
          f"{nbytes / 1e9:.3f} GB -> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{ops / 1e9:.2f} GFLOP -> f32 bound {ops / F32_FLOPS * 1e3:.4f} ms", flush=True)
    return ka, kc


def check_walk(tree, acts_bkt, nxt_bkt, max_levels, report):
    import torch
    from boardlaw_tpu_torch.mcts import kernels

    B, K, T = acts_bkt.shape
    acts = acts_bkt.permute(1, 0, 2).reshape(K * B, T)
    nxt = nxt_bkt.permute(1, 0, 2).reshape(K * B, T)
    out = kernels.walk(tree.terminal, acts, nxt, max_levels)
    ref = kernels.walk_ref(tree.terminal, acts, nxt, max_levels)
    torch.cuda.synchronize()
    for name, o, r in zip(("parents", "actions", "halt_child", "path"), out, ref):
        if not torch.equal(o, r):
            fail(f"walk {name} differs from the twin ({int((o != r).sum())} entries)")
    levels = int((ref[3] >= 0).sum())
    depth = int((ref[3] >= 0).sum(1).max())
    print(f"walk vs twin at (N,T,L)=({K * B},{T},{max_levels}): all four outputs bit-equal; "
          f"{levels} levels visited, deepest {depth}", flush=True)
    k_ms = time_ms(lambda: kernels.walk(tree.terminal, acts, nxt, max_levels), 20)
    r_ms = time_ms(lambda: kernels.walk_ref(tree.terminal, acts, nxt, max_levels), 5)
    N, L = ref[3].shape
    nbytes = levels * 9 + N * (L + 3) * 4  # useful bytes read, bytes written
    sectors = levels * 3 * 32 + N * (L + 3) * 4  # each level's 3 reads as whole sectors
    report["walk"] = dict(ms=k_ms, plain_ms=r_ms, max_abs_err=0.0, bytes=nbytes, ops=0)
    print(f"walk: kernel {k_ms:.4f} ms, twin {r_ms:.4f} ms (median); {nbytes / 1e6:.2f} MB "
          f"-> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms; counted in 32-byte "
          f"sectors {sectors / 1e6:.2f} MB -> {sectors / HBM_BYTES_PER_S * 1e3:.5f} ms", flush=True)


def check_search_cpu_vs_gpu(cfg, model):
    """A small 9x9 search on the card (kernels) against the same search on
    the CPU (twins), with the same weights and draws."""
    import copy
    import torch
    from boardlaw_tpu_torch import learning
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    class ToCuda(Draws):
        def __init__(self, seed):
            super().__init__(seed, "cpu")

        def uniform(self, shape, minval=0.0):
            return super().uniform(shape, minval).cuda()

        def normal(self, shape):
            return super().normal(shape).cuda()

    B = 64
    worlds = learning.mix(hex.Hex.initial(B, cfg.boardsize, device="cpu"), Draws(5, "cpu"), 30)
    mcfg = cfg.mcts_config()
    cpu_model = copy.deepcopy(model).cpu()
    t_cpu = search.mcts(worlds, make_eval_fn(cpu_model), Draws(9, "cpu"), mcfg)
    gworlds = hex.Hex(board=worlds.board.cuda(), seats=worlds.seats.cuda())
    t_gpu = search.mcts(gworlds, make_eval_fn(model), ToCuda(9), mcfg)
    same = ((t_cpu.children == t_gpu.children.cpu()).flatten(1).all(1)
            & (t_cpu.n == t_gpu.n.cpu()).all(1)
            & (t_cpu.n_edge == t_gpu.n_edge.cpu()).flatten(1).all(1))
    n_same = int(same.sum())
    w_err = float((t_cpu.w - t_gpu.w.cpu())[same].abs().max())
    print(f"search on the card vs on the CPU (9x9, {B} envs, 512x{cfg.depth}): {n_same}/{B} "
          f"trees identical in children/n/n_edge, max |w| difference on those {w_err:.3g}",
          flush=True)
    if n_same < B - 4 or w_err > 1e-4:
        fail("the search on the card disagrees with the search on the CPU")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=32 * 1024)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. the kernels
    t0 = time.time()
    kernels.build(verbose=True)
    print(f"kernels built in {time.time() - t0:.2f} s", flush=True)

    cfg = train.TrainConfig(boardsize=9, width=512, depth=4, n_envs=args.envs)
    mcfg = cfg.mcts_config()
    model = train.build_model(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(args.seed))

    # 3. kernels against their twins at the main path's shapes
    report = {}
    draws = Draws(args.seed + 1, "cuda")
    tree = mid_search_tree(cfg, model, draws, cfg.n_envs, passes=5)
    ka, kc = check_node_actions(tree, cfg, draws, report)
    # the last grow pass's shapes: all T rows, p+2 = n_passes+1 levels
    check_walk(tree, ka, kc, mcfg.n_passes + 1, report)
    del tree, ka, kc
    check_search_cpu_vs_gpu(cfg, model)
    torch.cuda.empty_cache()

    # 4. the main path
    kernels.walk.launches = 0
    kernels.node_actions_multi.launches = 0
    torch.cuda.reset_peak_memory_stats()
    draws = Draws(args.seed, "cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    worlds = train.init_worlds(cfg, draws)
    torch.cuda.synchronize()
    mix_s = time.time() - t0
    model = train.build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(args.seed))
    step_s = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.time()
        new_worlds, record, tree = train.actor_record(cfg, model, worlds, draws, return_tree=True)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        valid = worlds.valid
        if not (tree.n[:, 0] == 2 * mcfg.leaves_per_pass * mcfg.n_passes).all():
            fail(f"root visits {tree.n[:, 0].unique().tolist()}, expected "
                 f"{2 * mcfg.leaves_per_pass * mcfg.n_passes}")
        if int(record["n_leaves"].max()) > mcfg.n_nodes:
            fail("more leaves than nodes")
        logits = record["logits"].float()
        if not torch.equal(torch.isneginf(logits), ~valid):
            fail("root logits are not -inf exactly at the invalid actions")
        if not (torch.isfinite(logits[valid]).all() and torch.isfinite(record["v"]).all()
                and torch.isfinite(record["rewards"]).all()):
            fail("non-finite outputs")
        worlds = new_worlds
    launches = {"walk": kernels.walk.launches, "node_actions_multi": kernels.node_actions_multi.launches}
    want = mcfg.n_passes * args.steps
    print(f"launches over {args.steps} actor steps: {launches} (expected {want} each)", flush=True)
    if any(v != want for v in launches.values()):
        fail("a kernel was not launched once per pass on the main path")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    sims = cfg.n_envs * mcfg.n_passes * mcfg.leaves_per_pass / steady
    print(f"actor step (9x9, 512x4, {cfg.n_envs} envs, 64 nodes, K=8): steps {step_s} s, "
          f"median after the first {steady:.4f} s/step, {sims:.0f} sims/s, mix {mix_s:.2f} s, "
          f"peak memory {peak_gb:.2f} GB; card: {card}", flush=True)

    # 5. the records
    sources = {
        "walk": ("cuda", "boardlaw_tpu_torch/csrc/walk.cu",
                 "boardlaw_tpu/mcts/pallas_kernels.py:530"),
        "node_actions_multi": ("cuda", "boardlaw_tpu_torch/csrc/node_actions_multi.cu",
                               "boardlaw_tpu/mcts/pallas_kernels.py:327"),
    }
    rows = []
    for name, (route, source, replaces) in sources.items():
        r = report[name]
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
