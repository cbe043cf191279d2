"""End-to-end compute-scaling study on the PyTorch/CUDA port
(boardlaw_tpu_torch): scripts/scaling_study.py's stages and flags, plus
--device (default: the card).

Trains a ladder of net sizes at one boardsize with log-spaced FLOP snapshots
(reference boardlaw/main.py:147 + storage.py:56-120), league-evaluates every
snapshot against every other (reference arena/neural.py:229-294), solves MLE
Elos from the trials table, fits the compute-frontier changepoint model, and
writes the Elo-vs-compute figure + dataframe (reference analysis/data.py:
59-145, docs/flops_curves.svg).

Stages are separate subcommands, each resumable (training by run,
evaluation by what is already in the trials table). `train` and `evaluate`
read the database as numpy rows and run where pandas is absent; `fit` and
`gap` need pandas and matplotlib.

Usage:
    python scripts/torch_scaling_study.py train   [--boardsize 7] [--envs 1024]
                                                  [--steps 2000] [--sizes w:d,...]
    python scripts/torch_scaling_study.py evaluate [--boardsize 7] [--envs-per 4]
    python scripts/torch_scaling_study.py fit     [--boardsize 7]
    python scripts/torch_scaling_study.py all     [...] [--device cuda]
"""
import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DESC = "scaling-study"
DEFAULT_SIZES = "16:1,32:1,64:2,128:2,256:2"


def parse_sizes(s):
    return [tuple(map(int, wd.split(":"))) for wd in s.split(",")]


def _device(args):
    return getattr(args, "device", None)  # test harnesses build bare Namespaces


def train(args):
    from boardlaw_tpu_torch import train as T

    desc = getattr(args, "desc", DESC)

    done = []
    for width, depth in parse_sizes(args.sizes):
        t0 = time.time()
        run = T.run(
            args.boardsize,
            width,
            depth,
            desc=desc,
            n_envs=args.envs,
            storer="flops",
            max_steps=args.steps,
            arena=False,
            dtype=args.dtype,
            tree_dtype=args.dtype,
            leaves_per_pass=args.k,
            seed=args.seed,
            device=_device(args),
        )
        done.append(run)
        print(
            f"[scaling] trained {width}x{depth} -> {run} "
            f"({time.time() - t0:.0f}s)",
            flush=True,
        )
    return done


def evaluate(args):
    """League-evaluate every scaling-study snapshot, skipping pairs already
    in the trials table (so reruns only add games). Returns the league's
    `Trials` (None when nothing was played)."""
    from boardlaw_tpu_torch import sql
    from boardlaw_tpu_torch.arena import common, neural

    sql.refresh()
    ags = sql.agent_query()
    desc = getattr(args, "desc", DESC)
    ags = ags.take((ags.boardsize == args.boardsize) & (ags.description == desc))
    if len(ags) < 2:
        print(f"[scaling] only {len(ags)} agents registered - train first")
        return None

    kwargs = {}
    if args.test_k > 1:
        # the league searches with the batched K-leaf search in grow mode:
        # every agent searches the same way, in a fraction of the K=1 time
        kwargs = {"leaves_per_pass": args.test_k, "grow_passes": True}
    agents = {}
    for row in ags:
        a = common.agent(row.run, int(row.idx), device=_device(args), **kwargs)
        if a is not None:
            agents[int(row.id)] = a
    print(f"[scaling] league of {len(agents)} agents", flush=True)

    played = sql.trial_query(args.boardsize, desc)
    seen = {(int(b), int(w)) for b, w in zip(played.black_agent, played.white_agent)}
    # --top-up replays already-played pairs too: trials accumulate in the
    # DB, so a second sweep doubles the games behind every Elo estimate
    top_up = getattr(args, "top_up", False)
    matchups = [m for m in neural.all_matchups(list(agents)) if top_up or m not in seen]
    if not matchups:
        print("[scaling] all matchups already played")
        return None
    n_envs = min(len(matchups) * args.envs_per, args.league_envs)
    n_envs = max(n_envs - n_envs % 2, 2)
    ev = neural.ChunkEvaluator(args.boardsize, n_envs, agents, matchups, args.envs_per,
                               device=_device(args))
    t0 = time.time()
    trials = ev.play(progress_every=30)
    secs = time.time() - t0
    rows = [(int(b), int(w), int(bw), int(ww), 0, 0.0) for b, w, bw, ww in trials.rows()]
    sql.save_trials(rows)
    games = float((trials.black_wins + trials.white_wins).sum())
    print(f"[scaling] saved {len(rows)} trial rows ({games:.0f} games in {secs:.2f} s, "
          f"{games / secs:.2f} games/s)", flush=True)
    return trials


def seed_gaps(df):
    """Per-(width, depth) seed-repeat dispersion: for every rung with >=2
    runs, interpolate each run's Elo-vs-flops curve onto a common grid and
    return {rung: (n_seeds, span_series_in_elo)}: the within-seed variance
    a frontier reproduction is held to."""
    from boardlaw_tpu_torch.scaling import data

    out = {}
    for (w, d), g in df.groupby(["width", "depth"]):
        if g.run.nunique() < 2:
            continue
        curves = data.interp_curves(g).dropna()
        if len(curves) == 0 or curves.shape[1] < 2:
            continue
        span = (curves.max(1) - curves.min(1)) * data.ELO
        out[f"{int(w)}x{int(d)}"] = (int(g.run.nunique()), span)
    return out


def fit(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from boardlaw_tpu_torch.scaling import data

    df = data.load(getattr(args, "desc", DESC), device=_device(args))
    df = df[df.boardsize == args.boardsize]
    if len(df) == 0:
        # fall back to a committed frontier export (results/) so the fit is
        # reproducible from the repo alone, without the live trials DB
        import pandas as pd

        csv = f"results/scaling/frontier_b{args.boardsize}.csv"
        if os.path.exists(csv):
            df = pd.read_csv(csv, index_col=0)
            print(f"[scaling] DB empty — refitting committed {csv}")
        else:
            print("[scaling] no evaluated agents — run evaluate first")
            return

    outdir = "output/experiments/scaling"
    os.makedirs(outdir, exist_ok=True)
    df.to_csv(f"{outdir}/frontier_b{args.boardsize}.csv")

    # Fit the changepoint model to the frontier (the upper envelope over runs
    # on a common log-flops grid), as `data.modelled_elos` does: fitting every
    # sub-frontier snapshot instead flattens the incline and inflates the RMSE
    frontier = data.interp_frontier(df).reset_index()
    frontier["boardsize"] = float(args.boardsize)
    t0 = time.time()
    params = data.fit_model(frontier, device=_device(args))
    fit_s = time.time() - t0
    fitted = data.apply_model(params, frontier)

    fig, ax = plt.subplots(figsize=(7, 5))
    for run, g in df.sort_values("train_flops").groupby("run"):
        label = f"{int(g.width.iloc[0])}x{int(g.depth.iloc[0])}"
        ax.plot(g.train_flops, g.elo * data.ELO, "-o", ms=3, label=label)
    ax.plot(frontier.train_flops, frontier.elo * data.ELO, "-", color="0.5",
            lw=1, label="frontier (envelope)")
    ax.plot(
        frontier.train_flops.values,
        fitted.values * data.ELO,
        "k--",
        lw=1,
        label="frontier fit",
    )
    ax.set_xscale("log")
    ax.set_xlabel("train FLOPs")
    ax.set_ylabel("Elo")
    ax.set_title(f"Elo vs compute, {args.boardsize}x{args.boardsize} Hex")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(f"{outdir}/flops_curves_b{args.boardsize}.png", dpi=150)

    # goodness of fit and the frontier's shape. The changepoint model is elo = clip(max(incline @ [logF, b, 1],
    # plateau @ [b, 1]), None, 0) in nats; incline[0] * ELO is the frontier
    # slope in Elo per decade of train compute — the paper's headline
    # "~500 Elo per 10x compute" shape constant to compare against.
    resid = (frontier.elo - fitted) * data.ELO
    ss_res = float(np.square(resid).sum())
    ss_tot = float(np.square((frontier.elo - frontier.elo.mean()) * data.ELO).sum())
    incline = params["incline"].double().tolist()
    plateau = params["plateau"].double().tolist()
    # the model evaluates in the centered basis (data._CENTER = [12, 6])
    bc = float(args.boardsize) - 6.0
    plat = plateau[0] * bc + plateau[1]
    # changepoint: log10 flops where the incline crosses the plateau
    cp = 12.0 + (plat - (incline[1] * bc + incline[2])) / incline[0]
    summary = {
        "boardsize": args.boardsize,
        "n_agents": int(len(df)),
        "n_runs": int(df.run.nunique()),
        "elo_span": float((df.elo.max() - df.elo.min()) * data.ELO),
        "params": {k: v.tolist() for k, v in params.items()},
        "fit_rmse_elo": float(np.sqrt(np.square(resid).mean())),
        "fit_r2": 1.0 - ss_res / max(ss_tot, 1e-9),
        "slope_elo_per_decade": incline[0] * data.ELO,
        "plateau_elo": plat * data.ELO,
        "changepoint_log10_flops": cp,
        "fit_seconds": fit_s,
    }
    # seed-repeat dispersion: where two runs share a (width, depth) rung,
    # interpolate both onto a common flops grid and report the mean |Elo gap|
    # (the within-seed variance a frontier reproduction is held to)
    gaps = [float(span.mean()) for _, span in seed_gaps(df).values()]
    if gaps:
        summary["seed_repeat_mean_elo_gap"] = float(np.mean(gaps))
        summary["seed_repeat_rungs"] = len(gaps)
    with open(f"{outdir}/fit_b{args.boardsize}.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[scaling] {json.dumps(summary)}", flush=True)


def gap(args):
    """Seed-repeat dispersion, self-contained: for every (width, depth) rung
    of --desc's league with >=2 runs (seeds), interpolate each seed's
    Elo-vs-flops curve onto a common grid and report the mean/max Elo spread.
    Writes output/experiments/scaling/seed_repeat_b{boardsize}.json and, if
    `fit` wrote a frontier fit for the boardsize there, annotates it with the
    gap (the committed results/ of the JAX study are left as they are)."""
    import numpy as np

    from boardlaw_tpu_torch.scaling import data

    desc = getattr(args, "desc", DESC)
    df = data.load(desc, device=_device(args))
    df = df[df.boardsize == args.boardsize]
    if len(df) == 0:
        print("[scaling] no evaluated agents for gap — run evaluate first")
        return
    rungs = {
        rung: {
            "n_seeds": n,
            "n_grid_points": int(len(span)),
            "mean_elo_gap": float(span.mean()),
            "max_elo_gap": float(span.max()),
        }
        for rung, (n, span) in seed_gaps(df).items()
    }
    if not rungs:
        print("[scaling] no rung has >=2 seed runs")
        return
    summary = {
        "boardsize": args.boardsize,
        "desc": desc,
        "rungs": rungs,
        "seed_repeat_mean_elo_gap": float(
            np.mean([r["mean_elo_gap"] for r in rungs.values()])),
    }
    outdir = "output/experiments/scaling"
    os.makedirs(outdir, exist_ok=True)
    out = f"{outdir}/seed_repeat_b{args.boardsize}.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    fitf = f"{outdir}/fit_b{args.boardsize}.json"
    if os.path.exists(fitf):
        with open(fitf) as f:
            fit_summary = json.load(f)
        fit_summary["seed_repeat_mean_elo_gap"] = summary["seed_repeat_mean_elo_gap"]
        fit_summary["seed_repeat_rungs"] = len(rungs)
        with open(fitf, "w") as f:
            json.dump(fit_summary, f, indent=2)
    print(f"[scaling] {json.dumps(summary)}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("stage", choices=["train", "evaluate", "fit", "gap", "all"])
    p.add_argument("--desc", default=DESC,
                   help="run description / league namespace (seed-repeat "
                        "studies use their own so they don't contaminate "
                        "the main frontier league)")
    p.add_argument("--boardsize", type=int, default=7)
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--sizes", default=DEFAULT_SIZES)
    p.add_argument("--k", type=int, default=1,
                   help="leaves_per_pass for the training search (8 = fast)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--envs-per", type=int, default=4)
    p.add_argument("--test-k", type=int, default=1,
                   help="league-evaluation search leaves_per_pass")
    p.add_argument("--seed", type=int, default=0,
                   help="TrainConfig seed (for seed-repeat rungs)")
    p.add_argument("--league-envs", type=int, default=1024)
    p.add_argument("--top-up", action="store_true",
                   help="replay already-played pairs (accumulate games)")
    p.add_argument("--device", default=None,
                   help="where training, the league and the fit run (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")

    if args.stage in ("train", "all"):
        train(args)
    if args.stage in ("evaluate", "all"):
        evaluate(args)
    if args.stage in ("fit", "all"):
        fit(args)
    if args.stage == "gap":
        gap(args)


if __name__ == "__main__":
    main()
