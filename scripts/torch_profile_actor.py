"""Where the time of one 9x9 actor step of the PyTorch/CUDA port goes.

    python3 scripts/torch_profile_actor.py [--envs 32768] [--out output/profile_actor.txt]

Builds the port's main path (mix, random 512x4 FCModel, K=8 grow-pass
search), runs two warm-up actor steps, then one step under torch.profiler
(CPU and CUDA activities). Prints the card line, the step's wall time, the
device busy share (sum of kernel times over the wall time) and the CUDA
kernels by total time; the full table goes to --out.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=32 * 1024)
    parser.add_argument("--mix", type=int, default=2500)
    parser.add_argument("--out", default="output/profile_actor.txt")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = train.TrainConfig(boardsize=9, width=512, depth=4, n_envs=args.envs, mix_steps=args.mix)
    draws = Draws(0, "cuda")
    worlds = train.init_worlds(cfg, draws)
    model = train.build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        worlds, _ = train.actor_record(cfg, model, worlds, draws)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        worlds, _ = train.actor_record(cfg, model, worlds, draws)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\nwall {wall:.4f} s, device busy {device_us / 1e6:.4f} s\n{table}\n")
    print(card)
    print(f"actor step at {args.envs} envs: wall {wall:.4f} s, kernels {device_us / 1e6:.4f} s, "
          f"device busy share {device_us / 1e6 / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
