"""Time phases of chip_smoke.py on their own on the card, so that two
checkouts' phases can be compared in one call.

    python scripts/torch_smoke_phases.py prepare ROOT
        builds the kernels and writes phases 7 and 9's runs (phase 11's
        input) into the run root ROOT, and the name of phase 7's run into
        ROOT.run
    python scripts/torch_smoke_phases.py 11 ROOT
        phase 11 (the results database and the scaling study, in its own
        spawned process, as chip_smoke.py runs it) on a fresh copy of ROOT
    python scripts/torch_smoke_phases.py 12 [--fleet-envs N]
        phase 12 (the fleet, backup and the run tools), its jobs at N envs
        (default: chip_smoke.py's)

The phases timed are those of the chip_smoke.py beside this script's
`scripts/` folder: a copy of the script in another checkout times that
checkout's phases, and phase 11 of both on one ROOT reads the same runs.
Prints the card's name and power limit and each phase's seconds; exits
with 1 where no card is visible.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[1]


def smoke_args(seed):
    """chip_smoke.py's arguments at their defaults."""
    return argparse.Namespace(envs=32 * 1024, steps=3, k1_learner_envs=32 * 1024,
                              layout_envs=1024, seed=seed)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phase", choices=("prepare", "11", "12"))
    parser.add_argument("root", nargs="?")
    parser.add_argument("--fleet-envs", type=int)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.phase != "12" and not args.root:
        parser.error(f"phase {args.phase} needs ROOT")

    sys.path.insert(0, str(TREE))
    os.chdir(TREE)  # chip_smoke imports `scripts` and reads tests/ from its root
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from boardlaw_tpu_torch.mcts import kernels
    from boardlaw_tpu_torch.pavlov.tests import mock_dir

    card = chip_smoke.card_line()
    print(f"{TREE}: phase {args.phase}; card: {card}", flush=True)
    t0 = time.time()
    kernels.build()
    print(f"build or load of the kernels: {time.time() - t0:.2f} s", flush=True)
    sargs = smoke_args(args.seed)
    if args.phase == "prepare":
        root = Path(args.root).resolve()
        root.mkdir(parents=True)
        with mock_dir(str(root)):
            with chip_smoke.Phase("train.run and resume"):
                _, run = chip_smoke.check_train_run(sargs, card, float("nan"))
            with chip_smoke.Phase("evaluation"):
                chip_smoke.check_evaluation(sargs, card, run, {})
        Path(f"{root}.run").write_text(run)
    elif args.phase == "11":
        run = Path(f"{args.root}.run").read_text()
        with tempfile.TemporaryDirectory(prefix="smoke-phase11-") as tmp:
            copy = shutil.copytree(args.root, os.path.join(tmp, "runs"))
            with mock_dir(copy), chip_smoke.Phase("the results database and the scaling study"):
                chip_smoke.check_results_database_spawned(sargs, run, {})
    else:
        if args.fleet_envs:
            chip_smoke.FLEET_GRID["n_envs"] = args.fleet_envs
        with chip_smoke.Phase(f"the fleet, backup and the run tools "
                              f"({chip_smoke.FLEET_GRID['n_envs']} envs)"):
            chip_smoke.check_fleet(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
