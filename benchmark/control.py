"""The readings a cell's limits are set from, at the cell's own size:

    python benchmark/control.py --workload <name> --seeds 1 2 3 [--seconds 5]

For each seed, in one process, the readings of the cell's loop
(`kinds/<kind>.py`'s `control`): the program's outputs against the plain
reference at the configuration's precision, the yardstick a run uses (the
lower reading); the control, the reference one precision lower in the
program's place (`control_precision`), against the same reference (the
upper reading); and the faults the reference can carry, at the
configuration's precision: the root policy altered where it is produced
("answer") and, for a training cell, the loss over half the batch
("half"). A state left unchanged reads 1 on `grad` and `change` and needs
no run. A league plays `--seconds` before its plies are read. One JSON
line a seed. The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_precision(device, cfg):
    """The precision next below the configuration's: float8 for bfloat16;
    for float32 TF32 on a card, where it exists, and bfloat16 on a CPU."""
    from benchmark.kinds.selfplay import precision

    if precision(cfg) == "bfloat16":
        return "float8"
    return "tf32" if device.type == "cuda" else "bfloat16"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import spec

    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        start = time.perf_counter()
        out = cell.kind().control(cell, seed, device, args.seconds)
        out.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - start)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
