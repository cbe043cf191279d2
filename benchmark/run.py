"""Run one cell of BENCHMARK.json once, on the card, and print its result as
the last line of standard output:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run imports the port (`boardlaw_tpu_torch`) and neither JAX nor the JAX
package, builds or loads the port's kernels from `boardlaw_tpu_torch/_build/`,
makes the weights and draws from `--seed`, sets up and warms the cell's
shapes, then measures for `--seconds` (`--trace 0`: the end-to-end metrics)
or profiles a fixed number of steps (`--trace 1`: the per-layer metrics, the
trace written under `benchmark/_traces/`). The compared numbers and their
limits close standard error and the result line. Without a card the run
exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of a build or a kernel at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
