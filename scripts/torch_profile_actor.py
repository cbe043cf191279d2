"""Where the time of the PyTorch/CUDA port's steps goes, on one GPU.

    python3 scripts/torch_profile_actor.py [--envs 32768] [--mix 2500] [--scan]
        [--dtype float32|bfloat16] [--tree-dtype float32|bfloat16]
        [--out output/profile_actor.txt]

Profiles three steps, each after two warm-up calls of the same step, under
torch.profiler (CPU and CUDA activities):

1. a 9x9 actor step (`make_config(9, 512, 4)`: random 512x4 FCModel, K=8
   grow-pass search);
2. a 9x9 `train_step` of the same config (actor step, buffer push,
   reward-to-go, one Adam step; the buffer is not warmed up, which changes
   its contents, not the work);
3. a 6x6 K=1 actor step (`best_config(6)`: 128x1 model, 63 sequential sims
   through the `node_actions`, `walk` and `backup` kernels).

With --scan, steps 1 and 2 run the 9x9 scan-mode search instead (every pass
over all 65 rows, `solve_kernel="probs"`, `sample_kernel=True`: the
`solve_probs`, `sample_children_multi` and `walk` kernels), and step 3 is
left out.

--dtype and --tree-dtype set `TrainConfig.dtype` (the network's compute
type) and `tree_dtype` (the tree's logits) of every step profiled; the JAX
flagship runs both in bfloat16.

For each it prints the card line, the step's wall time under the profiler
and that of the warm-up call before it, the device busy share (sum of
kernel times over the profiled wall time), the CUDA kernels by total time,
and three sums: the `walk` kernel's time and calls, those of every copy
kernel (PyTorch's `direct_copy_kernel` and memcpy; on a tree whose
`simulate_multi` copies the sampler's buffers to rows for `walk`, those
copies are among them), and those of the network's matrix products (every
cuBLAS kernel and cuBLASLt's split-K reductions, by `benchmark/trace.py`'s
`GEMM` names); the full tables go to --out. --package-root imports
`boardlaw_tpu_torch` from another checkout (an unpacked `git archive` of an
earlier commit), so that one call can profile two trees on one card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_step(label, fn, out):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the second warm-up call's wall is the unprofiled reading
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        bare = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    out.write(f"== {label}\nwall {wall:.4f} s ({bare:.4f} s unprofiled), device busy "
              f"{device_us / 1e6:.4f} s\n{table}\n")
    print(f"== {label}: wall {wall:.4f} s ({bare:.4f} s unprofiled), kernels "
          f"{device_us / 1e6:.4f} s, device busy share {device_us / 1e6 / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    from benchmark.trace import GEMM

    for name, match in (("walk", lambda k: "walk" in k), ("copy", lambda k: "copy" in k.lower()),
                        ("GEMM", lambda k: any(g in k.lower() for g in GEMM))):
        chosen = [e for e in events if match(e.key)]
        line = (f"{name} kernels: {sum(e.self_device_time_total for e in chosen) / 1e3:.3f} ms "
                f"in {sum(e.count for e in chosen)} calls")
        out.write(line + "\n")
        print(f"== {label}: {line}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=32 * 1024)
    parser.add_argument("--mix", type=int, default=2500)
    parser.add_argument("--scan", action="store_true",
                        help="profile the 9x9 scan-mode actor and train steps only")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="the network's compute dtype")
    parser.add_argument("--tree-dtype", default="float32", choices=("float32", "bfloat16"),
                        help="the storage dtype of the tree's logits")
    parser.add_argument("--package-root", default=None,
                        help="import boardlaw_tpu_torch from this checkout")
    parser.add_argument("--out", default="output/profile_actor.txt")
    args = parser.parse_args(argv)
    if args.package_root is not None:
        sys.path.insert(0, os.path.abspath(args.package_root))

    import torch

    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dtypes = dict(dtype=args.dtype, tree_dtype=args.tree_dtype)
    print(f"{card}; network {args.dtype}, tree logits {args.tree_dtype}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        out.write(f"{card}; network {args.dtype}, tree logits {args.tree_dtype}\n")
        draws = Draws(0, "cuda")

        scan = {}
        if args.scan:
            scan = dict(grow_passes=False, solve_kernel="probs", sample_kernel=True)
        mode = "scan passes, solve_probs + sample_children_multi" if args.scan else "grow passes"
        cfg9 = train.make_config(9, 512, 4, n_envs=args.envs, mix_steps=args.mix, **scan, **dtypes)
        model, _, init, _, train_step = train.make_train(cfg9, device="cuda")
        state = init(draws)
        worlds = state.worlds

        def actor9():
            nonlocal worlds
            worlds, _ = train.actor_record(cfg9, model, worlds, draws)

        profile_step(f"9x9 actor step (K=8, {mode}, {args.envs} envs)", actor9, out)
        profile_step(f"9x9 train_step (K=8, {mode}, {args.envs} envs)",
                     lambda: train_step(state, draws), out)
        del state, worlds
        if args.scan:
            return 0

        cfg6 = train.best_config(6, n_envs=args.envs, mix_steps=args.mix, **dtypes)
        model6 = train.build_model(cfg6, device="cuda", generator=torch.Generator().manual_seed(0))
        worlds6 = train.init_worlds(cfg6, draws)

        def actor6():
            nonlocal worlds6
            worlds6, _ = train.actor_record(cfg6, model6, worlds6, draws)

        profile_step(f"6x6 K=1 actor step ({args.envs} envs)", actor6, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
