"""Smoke run of the PyTorch/CUDA port (boardlaw_tpu_torch) on one GPU.

    python3 chip_smoke.py [--envs 32768] [--steps 3] [--k1-learner-envs 32768]
        [--layout-envs 1024] [--seed 0]

Phases, each a hard failure with a non-zero exit, each printing its seconds:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  2. build the ten CUDA kernels from boardlaw_tpu_torch/csrc (nvcc, sm_90a),
     in every instantiation: four of them (`node_actions_multi`,
     `node_actions`, `descend`, `solve_probs`) also for bf16 logits, and
     the eight that read children or edge counts also for the wide tree;
  3. the K=8 kernels against their plain PyTorch twins at the shapes of the
     9x9 main path's last pass, on a real mid-search tree:
     `node_actions_multi` draw for draw up to roundoff at CDF boundaries and
     its alpha to rtol 1e-5; `walk` on its (K,B,R) views of the sampler's
     (B,K,R) buffers, as the search hands them, at the first and the last
     grow pass's shapes ((R, L) = (9, 2) on a tree before its first pass,
     (65, 9) on the mid-search tree): every design of csrc/walk.cu
     (`kernels.WALK_DESIGNS`) bit-equal to the twin in all four outputs and
     timed, with the byte counts of `walk_bytes`; `backup_prefix` on the
     inputs of a real search's last grow pass, bit-equal in n, w, n_edge and
     w_edge to its twin `search.backup_paths_prefix` on the card and to a
     second launch, in n, w and n_edge to the twin on the CPU (w_edge within
     two orders' roundoff), timed beside the twin on the card and the byte
     counts of `backup_prefix_bytes`; a small 9x9 search on the card against the
     same search on the CPU (twins);
  3b. the split K=8 kernels at the 9x9 scan pass's shapes ((B,T,A) =
     (32768, 65, 81)), on a real tree after 5 scan passes: `solve_probs`
     probs against `search.node_probs` (rtol 1e-5, atol 1e-7), its alpha
     equal to `node_actions_multi`'s, `sample_children_multi` equal to its
     twin in every draw, the split pair equal to `node_actions_multi` in
     every draw; a small 9x9 scan search on the card against the CPU;
  3c. the row kernels in every lane layout (`kernels.row_layout`): for each
     board of 3, 5, 6, 7, 9 and 11, with f32 and with bf16 tree logits, a
     K=1 tree of `--layout-envs` envs after 20 sims of a random 64x2 model,
     on which `node_actions` and `node_actions_multi` agree with their twins
     by the rules of phases 3 and 4, `descend` equals `node_actions` +
     `walk`, `backup` and `backup_dense` equal `search.backup` bit for bit
     and the split pair equals `node_actions_multi`; on the bf16 trees each
     bf16 instantiation equals the f32 kernel on the logits' f32 copy bit for
     bit;
  3d. the bf16 instantiations on real trees of the bf16 flagship
     configuration (`make_config(9, 512, 4, dtype="bfloat16",
     tree_dtype="bfloat16")`, and `best_config(6)` with the same two fields)
     at the shapes of phases 3, 3b and 4, by their rules: `node_actions_multi`
     on the 9x9 grow tree, `solve_probs` (and the split pair) on the scan
     tree, `node_actions` and `descend` on the 6x6 K=1 tree; each timed,
     bit-equal to the f32 kernel on `logits.float()` (the bf16 logits' f32
     copy), and allocating less than half an f32 copy of the logits (they
     are read in place);
  4. the K=1 kernels at the 6x6 path's shapes (`best_config(6)`, 32,768
     envs, T=64, A=36) on a real tree after 30 sims: `node_actions` draw for
     draw up to CDF boundaries, its alpha (a debug output) to rtol 1e-5 of
     the twin's and equal to `solve_probs`' at 16 Newton steps (timed on
     all T rows and on the tree.sim live rows the search hands it), `descend` equal to `node_actions` + `walk`,
     `backup` and `backup_dense` equal to `search.backup` bit for bit in n,
     w, n_edge and w_edge (timed there and on an all-chains tree of the same
     shapes, every env a chain of depth T-1, also bit-equal); `walk` by
     every design on the tree's (B,T) rows and on depth-63 chains, bit-equal
     to the twin and timed; a small 6x6 search on the card against the CPU;
  4b. `hex_step` (csrc/hex_step.cu) at the paths' shapes, on mixed worlds:
     the 9x9 grow pass's 8 x `--envs` boards and the 6x6 K=1 sim's `--envs`,
     int32 actions, bit-equal to its twin `envs.hex.step_reference` on the
     card, timed beside the twin, with the byte counts of `hex_step_bytes`;
  5. the paths, each driven with every launch count set to 0 just before and
     read just after, failing unless each of its kernels ran the expected
     number of times:
     a. 9x9 actor steps (`make_config(9, 512, 4)`: K=8 grow passes), 8
        launches of `walk`, `node_actions_multi` and `backup_prefix` per step,
        128 root visits;
     b. `--steps` (at least 2) K=1 actor steps at 6x6, 63 launches of
        `node_actions`, `walk` and `backup` per step, 126 root visits;
     d. the 9x9 learner: `make_train`, `init`, a full warmup (64 actor steps)
        and `--steps` (at least 2) train steps, all aux finite, parameters
        moved; its first two steps and its state are kept for phase 10;
     e. one 6x6 K=1 train step after its warmup, at `--k1-learner-envs`;
     f. a tiny train step on the card against the same step on the CPU:
        losses to rtol 1e-4; the same with a bf16 network and bf16 tree
        logits, losses to rtol `BF16_STEP_RTOL`;
     g. the 9x9 scan path (`make_config(9, 512, 4, grow_passes=False,
        solve_kernel="probs", sample_kernel=True)`) from 5a's worlds:
        `--steps` actor steps with 8 launches each of `solve_probs`,
        `sample_children_multi` and `walk` per step and 128 root visits, then
        one train step after a full warmup, aux finite, parameters moved;
     h. one 9x9 scan search per other route ('alpha' with the torch 'matmul'
        sampler, 'ops' with the sampler kernel, 'fused', the einsum backup,
        the warm solve) from the same worlds and draws, each with its launch
        counts, the trees held against 5g's route (equal on all but 1% of
        envs, w to atol 1e-4; the warm solve's invariants only);
     i. the bf16 flagship, `make_config(9, 512, 4, dtype="bfloat16",
        tree_dtype="bfloat16")`, from 5a's worlds: `--steps` actor steps
        with 8 launches each of `node_actions_multi.bf16` and `walk` and 128
        root visits, then the learner (a full warmup and `--steps` train
        steps, aux finite, parameters moved); one `best_config(6)` K=1 actor
        step with the same two fields (63 launches of `node_actions.bf16`,
        `walk` and `backup`), one 9x9 scan actor step (8 of
        `solve_probs.bf16`); the step seconds and peak memory beside 5a's,
        5b's, 5d's and 5g's float32 ones;
  6a. the planted-value games of `envs/validation.py` (`Win` and
     `WinnerLoser` at 3 nodes, `All(length=3)` with one and two seats and
     `SequentialMatrix.dilemma` at 15) at `--envs` envs by every search
     route (K=1; K=8 grow; K=8 scan with `solve_probs` +
     `sample_children_multi`), each with its launch counts: rows of 1 and 2
     actions, one seat, trees of 3 to 17 slots; the root value against the
     analytic one to 1e-5 and the root's visits; the same search on 64 envs
     on the card against the CPU (twins), draws from one CPU generator:
     children, parents, relation, n and n_edge bit-equal, w, w_edge and the
     root policy to 1e-6;
  6b. the JAX test's planted 3x3 Hex game (`hex.from_string`,
     `RandomAgent`, 63 nodes, c_puct 1) in `--envs` copies, each with its
     own draws: the JAX test's inequalities on the root policy in at least
     `PLANTED_SHARE` of them (they hold for its one key, not for every
     draw), and 64 copies on the card equal to the CPU's;
  7. `train.run(9, 512, 4, max_steps=10)` (f32, `--envs` envs) in a
     temporary run root, then `resume=` that run to 12 steps, each with its
     launch counts of `walk`, `node_actions_multi` and `backup_prefix`: the
     latest payload's
     step and sample count, a fresh `load_state_dict` of it equal to it bit
     for bit, the loop's stats channels, `count.samples` by the numpy
     reader; the set-up seconds, the median s/step inside `run` beside 5d's
     bare `train_step`, the snapshot writes' ms and the peak memory;
  8. the wide tree (`n_nodes` > 127: int32 children, f32 edge counts above
     128 slots, int32 with bf16 at 128) at full width, the 9x9 512x4
     FCModel: K=1 searches at 256 nodes (`--envs` envs) and at 128 nodes;
     one grow and one scan actor step of
     `make_config(9, 512, 4, nodes=512)` (T = 513) at half the envs; at
     4,096 envs the bf16-logits searches on wide trees and a one-pass
     K = 127 search (T = 128); each with its launch counts, seconds and
     peak memory. On mid-search trees every wide instantiation against its
     twin by the rules of phases 3, 3b and 4 (the backups and `walk` bit
     for bit, `walk` at (K, R, L) = (1, 256, 256), (1, 128, 128) and
     (8, 513, 65), `backup_prefix.wide` on the last grow pass at 512 nodes), the bf16 ones bit-equal to the f32 ones on the logits'
     f32 copy, the sampler's child pointers above 256 equal to the twin's;
     searches on the card against the CPU's (64 envs; 16 at 256 nodes);
  9. evaluation on phase 7's run: agents of its latest and first snapshot
     (K=1, 128 nodes) on 256 envs; `common.evaluate` of the two (K=8 grow,
     128 nodes) over 256 envs until every game ends, and the league of the
     two and `rollout-4` (`neural.evaluate`), each with games/s and moves/s;
     two `RollingArena.play` rounds (the ledger, activelo on the card,
     `elo-arena`); `train.run(3, 8, 1, max_steps=3, arena=True)`, whose
     spawned child writes the ledger and `elo-arena` before the run ends
     and is terminated with it; `PerfectAgent` against itself on 3x3 (black
     wins every game) and a 3x3 wide-tree agent (K=1, 200 nodes) against
     it; one external-ladder game against the bundled GTP engine;
  10. data parallelism (`parallel/`), the process pools and `utils/`:
     a. two ranks spawned on the one card over gloo
        (`parallel.distributed.launch`, `initialize`), `make_config(9, 512,
        4)` with `--envs` envs in all, half a rank: `init`, the full warmup
        and 2 train steps through `Draws(seed).shard(rank, 2)`, each rank's
        launches (8 of `walk`, `node_actions_multi` and `backup_prefix` an
        actor step), held
        against phase 5d's single process on the same draws: the ranks'
        parameters bit-equal, the pushed records equal env by env on all
        but `DP_DIVERGED_SHARE` of the envs (integer leaves equal, f32
        leaves to `DP_RECORD_ATOL`, bf16 ones to a bf16 step), the aux to
        `DP_AUX_RTOL`, the parameters to `DP_PARAM_RTOL`/`DP_PARAM_ATOL`;
        the s per train step beside 5d's, the gradient's and the q-bounds'
        all-reduce ms, the ms of a step's draws for all envs (what each
        rank generates) and each rank's peak memory;
     b. `train.run(9, 512, 4, n_devices=2)` on one card: ValueError naming
        the visible card count, no run left;
     c. phase 9's league by `neural.evaluate_parallel` over 2 spawned
        workers on the card, 8 games an ordered pair, games/s beside phase
        9's `neural.evaluate`;
     d. one more train step of 5d's state under `utils.profiling.trace`
        (the chrome trace names `walk` and `node_actions_multi`) between
        `utils.memory.Monitor` snapshots (a positive delta), and
        `memory.usage`'s total of the card.
     A rank or worker that fails or outlives its deadline fails the phase;
  11. the results database and the scaling study on phase 7's run, in a
     spawned process of its own (phase 10d's profiler trace leaves the
     card's tracing on in this one), with `BOARDLAW_DB` in a temporary
     directory and neither pandas nor matplotlib used
     (`check_results_database`): a. `sql.refresh()` over
     phases 7 and 9's run root, one agent row per snapshot; b.
     scripts/torch_scaling_study.py's `train` stage (`STUDY`: 9x9, 64x2 and
     512x4, 4,096 envs, 3 steps; two snapshots registered a run) and its
     `evaluate` stage (K=8 grow, 8 launches of `walk`, `node_actions_multi`
     and `backup_prefix` a search; every ordered pair of the four agents; a
     rerun adds nothing), `elos.solve` on the trials and `data.fit_model`
     on the card, with games/s, the fit's seconds and RMSE; c.
     `best.std_available(9)` and `best.evaluate(9, n_envs=256, rounds=1)`
     (K=1, 63 launches of `node_actions`, `walk` and `backup` a search); d.
     `noisescales.evaluate` on phase 7's latest snapshot (64 nodes, 1,024
     envs, 16 steps, its perf games): three finite rows over 1,176,150
     parameters, a second call adding nothing, the collection's and the
     gradients' seconds; e. `mohex_calibration.play_out` of `PerfectAgent`
     against itself on 3x3 (black wins every game) and `calibrate` of phase
     9's 3x3 run against tests/gtp_stub.py as the MoHex binary;
  12. the fleet, run backup and the run tools (`check_fleet`), the users'
     path for a sweep: `sweep.launch_grid(9, [64], [1, 2], n_envs=4096,
     max_steps=2)` in a temporary FLEET_ROOT, on one local machine of the
     one card, jobs launched without BOARDLAW_RUN_ROOT (each writes in its
     own directory), `manage.refresh` every second until both are dead
     (`FLEET_DEADLINE_S`): never two jobs active at once, the second
     launched when the first is dead; each job's log names the card, has no
     traceback, and its `kernels.launches` line the launches of its
     `train.run` (8 of `walk`, `node_actions_multi` and `backup_prefix` an
     actor step, the
     warmup's included); the archive carries the parent's built kernels, so
     no job runs nvcc; `manage.fetch`: two runs of `max_steps` rows of
     `time.step` and a checkpoint each; `backup.backup` and `backup.fetch`
     into a fresh run root equal file for file; `archive.archive` of the
     repo (its listing has `mcts/kernels.py`, equal to the file);
     `monitoring.tree_view` (the `loss` and `time` groups finite),
     `dashboard.render` (a chart for every channel) and one GET of
     `dashboard.serve`, all without pandas; each job's seconds from launch
     to dead, `time.setup.init` and s/step;
  13. a JSON line of kernel numbers (`walk`'s entry at the last grow pass's
     shape, with its figures at the first grow pass, the 6x6 K=1 tree, the
     chains and the wide trees beside, and each design's times; every
     instantiation (the keys of `kernels.launches`: `.bf16` logits, `.mixed`
     and `.wide` trees) as an entry of its own, with its launches from the
     path that runs it (phase 5 or 8; those of `descend` and
     `backup_dense`, which no search launches, from their checks against
     their twins in phases 3c, 3d, 4 and 8) and bounds counting its storage
     types; each kernel's launches on the paths of phases 6a, 6b, 7, 8, 9,
     10a (both ranks), 11b-11e and 12 (both jobs, under `fleet`) under
     `slice_launches`), and the last line
     {"ok": true, "device": {...}}.

Each row kernel's f32 operation bound counts the solver steps its inputs
need (`kernels.solve_steps`, printed as a histogram), not the step budget.
A kernel's reported `ms` is the time of one call on an idle card
(`time_ms`, the wrapper's host time before the launch included), as the
twins' `plain_ms` are; `device_ms` beside it is its time on the card
(calls enqueued behind a spin, so the host's time is hidden).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEV = "cuda"
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# bytes the backups need per visited level: parent 4, terminal 1, rewards 8,
# relation 4, the parent's seat 4, and read+write of n 8, w 16, n_edge 4,
# w_edge 8
BACKUP_BYTES_PER_LEVEL = 57


def solve_ops(steps, A):
    """float operations of the row solve over rows that need `steps` solver
    steps each (`kernels.solve_steps`): per (row, action lane) q (4), exp,
    count, lambda*pi, the initial bound (3), probs (2), and 8 per step the
    row needs."""
    return A * (12 * steps.numel() + 8 * int(steps.sum()))


def draw_ops(n_rows, A, K):
    """The prefix sum's add per level and 2 compares per draw, per (row,
    action lane)."""
    return n_rows * A * ((A - 1).bit_length() + 2 * K)


def steps_line(steps, A):
    """The histogram of solver steps per row, and the mean steps a warp runs:
    the most of its 32/G consecutive rows (`kernels.row_layout`)."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels

    per_warp = 32 // kernels.row_layout(A)[0]
    flat = steps.flatten()
    warps = torch.nn.functional.pad(flat, (0, -flat.numel() % per_warp)).view(-1, per_warp)
    counts = {int(k): int(v) for k, v in zip(*flat.unique(return_counts=True))}
    return (f"solver steps per row {counts}, mean {float(flat.float().mean()):.3f}; a warp of "
            f"{per_warp} rows runs {float(warps.amax(1).float().mean()):.3f} on average")


def row_bytes(tree):
    """Bytes of one (row, action lane) of the tree's solve inputs in their
    storage types: logits (4 or 2), n_edge (2 or 4), w_edge (4)."""
    return tree.logits.element_size() + tree.n_edge.element_size() + 4


def child_bytes(tree, draws):
    """Bytes of a row's children that `draws` draws need: the drawn ones
    (at most the row's A), each in the children's storage type (1 or 4).
    The rest of the row is never read by the function's definition."""
    return min(draws, tree.children.shape[-1]) * tree.children.element_size()


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps):
    """Median CUDA-event time of one call, after one warm-up call."""
    import torch

    fn()
    sync()
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


_SPIN_CYCLES_PER_MS = []


def device_ms(fn, reps):
    """The card's time per call of `fn`, without the host's: after one
    warm-up call, `reps` calls are enqueued behind a spin kernel that keeps
    the card busy until the host has enqueued them all, and CUDA events
    time them back to back. (`time_ms` starts its clock on an idle card, so
    it also counts the host's time before the launch: the wrapper's checks
    and the launch itself, some tens of microseconds.) A spin that ends
    before the last call is enqueued is made 4 times longer once; if that
    ends early too, `fn` synchronises, and the time says so."""
    import torch

    if not _SPIN_CYCLES_PER_MS:  # calibrate the spin once
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(10 ** 7 / max(start.elapsed_time(end), 1e-3))
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    spin_ms = 2e3 * reps * (time.perf_counter() - t0) + 1.0
    sync()
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS[0]))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = start.query()  # the spin ended before the last call was enqueued
        end.synchronize()
        if not starved:
            break
        spin_ms *= 4
    else:
        print("device_ms: the call synchronises; its time includes the host's", flush=True)
    return start.elapsed_time(end) / reps


def both_ms(fn, reps):
    """(`device_ms`, `time_ms`): the card's time and the time of a call."""
    return device_ms(fn, reps), time_ms(fn, reps)


def fail(msg):
    raise SystemExit(f"FAILED: {msg}")


def lap(label, t0):
    """Prints the seconds of a part of a phase since `t0`; returns now."""
    now = time.time()
    print(f"== {label}: {now - t0:.2f} s", flush=True)
    return now


class Phase:
    """Prints a phase's wall seconds when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        print(f"== {self.name}", flush=True)

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.time() - self.t0:.2f} s", flush=True)


def reset_counts():
    from boardlaw_tpu_torch.mcts import kernels

    for name in kernels.launches:
        kernels.launches[name] = 0


def read_counts():
    """Launches by instantiation, `kernels.launches`' keys."""
    from boardlaw_tpu_torch.mcts import kernels

    return dict(kernels.launches)


def instance(name, mcfg):
    """The `kernels.launches` name of the instantiation of kernel `name` that
    `mcfg`'s tree launches (`kernels.instance` over the types of
    `search.tree_dtypes` and `tree_dtype`)."""
    from boardlaw_tpu_torch.mcts import kernels, search

    return kernels.instance(name, mcfg.tree_dtype, *search.tree_dtypes(mcfg))


# the kernels no search launches: phases 3c, 3d, 4 and 8 hold them against
# their twins, and the record counts their launches there
HELD = ("descend", "backup_dense")


def held_launches(before):
    """The launches of `HELD`'s instantiations since the counts `before`."""
    return {k: v - before[k] for k, v in read_counts().items()
            if k.split(".")[0] in HELD and v > before[k]}


def search_launches(mcfg):
    """The kernel launches of one search under `mcfg`'s route."""
    if mcfg.leaves_per_pass == 1:
        sims = mcfg.n_nodes - 1
        return {"walk": sims, instance("node_actions", mcfg): sims,
                instance("backup", mcfg): sims}
    P = mcfg.n_passes
    out = {"walk": P}
    if mcfg.backup_mode == "prefix":
        out[instance("backup_prefix", mcfg)] = P
    if mcfg.solve_kernel == "fused":
        return out | {instance("node_actions_multi", mcfg): P}
    if mcfg.solve_kernel in ("probs", "alpha"):
        out[instance("solve_probs", mcfg)] = P
    if mcfg.sample_kernel:
        out[instance("sample_children_multi", mcfg)] = P
    return out


def search_counts(counts):
    """`counts` less `hex_step`, which launches for every Hex world a path
    steps (the mix, the actor, each expansion), not by its search route."""
    return {k: v for k, v in counts.items() if k != "hex_step"}


def run_path(name, expected, fn):
    """Drive one path with every count at 0 before; fail unless each kernel
    launched exactly `expected[name]` times (0 for kernels not listed,
    `hex_step` excepted)."""
    reset_counts()
    sync()
    out = fn()
    sync()
    counts = read_counts()
    want = {k: expected.get(k, 0) for k in (counts if "hex_step" in expected
                                             else search_counts(counts))}
    nonzero = {k: v for k, v in counts.items() if v}
    print(f"launches on {name}: {nonzero} (expected {expected}; every other instantiation 0)",
          flush=True)
    if {k: counts[k] for k in want} != want:
        fail(f"{name}: kernel launches {counts}, expected {want}")
    return counts, out


def hex_step_bytes(B, S, action_bytes=4):
    """The bytes `hex_step` must move for B boards of S x S: each board read
    and written, each seat read and written, the action read, the two f32
    rewards and the terminal flag written."""
    return B * (2 * S * S + 2 * 4 + action_bytes + 2 * 4 + 1)


def check_hex_step(seed, n_envs, report):
    """`hex_step` against its twin on the card at the 9x9 grow pass's K*B =
    8 * n_envs boards and the 6x6 K=1 sim's n_envs, from worlds mixed 40
    steps, with the search's int32 actions: every output bit-equal (the
    rewards' bit patterns too), then timed beside the twin; fills
    report["hex_step"] (9x9) and its "6x6"."""
    import torch
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.mcts import kernels

    draws = Draws(seed, DEV)
    figures = {}
    for S, B in ((9, 8 * n_envs), (6, n_envs)):
        worlds = mix_worlds(S, n_envs, draws, 40)
        board = worlds.board.repeat(B // n_envs, 1, 1)
        seats = worlds.seats.repeat(B // n_envs)
        valid = hex.Hex(board=board, seats=seats).valid
        noise = draws.gumbel(valid.shape)
        actions = torch.argmax(torch.where(valid, noise, -torch.inf), -1).to(torch.int32)
        got = kernels.hex_step(board, seats, actions)
        want = hex.step_reference(board, seats, actions)
        got, want = ([x.view(torch.int32) if x.dtype == torch.float32 else x for x in out]
                     for out in (got, want))
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        dev_ms, ms = both_ms(lambda: kernels.hex_step(board, seats, actions), 50)
        plain_ms = time_ms(lambda: hex.step_reference(board, seats, actions), 5)
        nbytes = hex_step_bytes(B, S)
        print(f"hex_step {S}x{S}, {B} boards: {mism} outputs differ from the twin; {ms:.4f} ms "
              f"({dev_ms:.4f} on the card), the twin {plain_ms:.4f} ms, {nbytes} bytes "
              f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
              f"{int(got[3].sum())} terminal", flush=True)
        if mism:
            fail(f"hex_step at {S}x{S}: {mism} outputs differ from the twin")
        figures[S] = {"max_abs_err": mism, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bytes": nbytes, "ops": 0, "shape": [B, S, S]}
    report["hex_step"] = {**figures[9], "6x6": figures[6]}


def mix_worlds(boardsize, n_envs, draws, steps):
    from boardlaw_tpu_torch import learning
    from boardlaw_tpu_torch.envs import hex

    return learning.mix(hex.Hex.initial(n_envs, boardsize, device=DEV), draws, steps)


# --------------------------------------------------------------------------
# K=8 kernels
# --------------------------------------------------------------------------

def mid_search_tree(cfg, model, draws, n_envs, passes):
    """A real tree after `passes` passes of the port's K=8 search."""
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    worlds = mix_worlds(cfg.boardsize, n_envs, draws, 40)
    mcfg = cfg.mcts_config()
    eval_fn = make_eval_fn(model)
    tree = search.build(worlds, mcfg)
    search.initialize(tree, eval_fn(worlds), draws, mcfg, worlds.valid)
    K = mcfg.leaves_per_pass
    for p in range(passes):
        R, L = search.pass_shape(mcfg, p)
        search.simulate_multi(tree, eval_fn, draws.pass_rands(p, (K, n_envs, R)), mcfg,
                              rows=R, max_levels=L)
    return tree


def boundary_counts(tree, q_bounds, mism, rands_at, ka, ra, alphas):
    """For each mismatched draw (indices `mism` into (B,[K,]T)): how many lie
    within 1e-5 of the CDF at the boundary lane min(ka, ra) for the first
    alpha, and how many between the CDFs of all given alphas (+-1e-5) there."""
    import torch
    from boardlaw_tpu_torch.mcts import search

    b, t = mism[0], mism[-1]
    A = tree.logits.shape[-1]
    q, counts = search._edge_q_counts(tree.n_edge[b, t], tree.w_edge[b, t], q_bounds)
    N = counts.sum(-1)
    lampi = (tree.c_puct[b] * N / (N + A))[:, None] * torch.exp(tree.logits[b, t].float())
    lane = torch.minimum(ka, ra).long().clamp_min(0)[:, None]
    r = rands_at[:, None]
    cums = [search._shift_cumsum(lampi / (alpha[b, t][:, None] - q)).gather(1, lane)
            for alpha in alphas]
    lo = torch.stack(cums).amin(0)
    hi = torch.stack(cums).amax(0)
    within_1e5 = int(((cums[0] - r).abs() <= 1e-5).sum())
    within_cdfs = int(((r >= lo - 1e-5) & (r <= hi + 1e-5)).sum())
    return within_1e5, within_cdfs


def multi_agrees(tree, rands, kw, label):
    """`node_actions_multi` against its twin on `tree` with rands (B,K,T):
    at least 99.99% of draws equal, every mismatch between the twin's and
    the kernel's CDF at its boundary lane, child pointers equal where the
    actions are, alpha within rtol 1e-5 on 99.99% of rows. Returns the
    kernel's actions, children and alpha and the twin's alpha."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    B, K, T = rands.shape
    A = tree.logits.shape[-1]
    args = (tree.logits[:, :T], tree.n_edge[:, :T], tree.w_edge[:, :T], tree.children[:, :T],
            rands, tree.c_puct, search._q_bounds(tree))
    ka, kc, kalpha = kernels.node_actions_multi(*args, return_alpha=True, **kw)
    ra, rc, ralpha = kernels.node_actions_multi_ref(*args, return_alpha=True, **kw)
    sync()
    rel = ((kalpha - ralpha).abs() / ralpha.abs()).flatten()
    alpha_ok = float((rel <= 1e-5).float().mean())
    mism = (ka != ra)
    n_mism = int(mism.sum())
    frac_equal = 1.0 - n_mism / ka.numel()
    child_ok = bool(((kc == rc) | mism).all())
    within_1e5 = within_cdfs = 0
    if n_mism:
        b, k, t = mism.nonzero(as_tuple=True)
        within_1e5, within_cdfs = boundary_counts(tree, args[-1], (b, t), rands[b, k, t],
                                                  ka[b, k, t], ra[b, k, t], (ralpha, kalpha))
    print(f"{label}: node_actions_multi vs twin at (B,K,T,A)=({B},{K},{T},{A}): draws equal "
          f"{frac_equal:.8f} ({n_mism} differ; {within_1e5} within 1e-5 of the twin's CDF at "
          f"the boundary lane, {within_cdfs} between the twin's and the kernel's CDF there), "
          f"alpha within rtol 1e-5 on {alpha_ok:.8f} of rows (max rel {float(rel.max()):.3g})",
          flush=True)
    if not child_ok:
        fail(f"{label}: node_actions_multi child pointers differ where the actions agree")
    if frac_equal < 0.9999:
        fail(f"{label}: node_actions_multi: fewer than 99.99% of draws equal the twin's")
    if within_cdfs != n_mism:
        fail(f"{label}: node_actions_multi: a mismatched draw is not explained by a CDF boundary")
    if alpha_ok < 0.9999 or float(rel.max()) > 1e-3:
        fail(f"{label}: node_actions_multi: alpha disagrees with the twin")
    return ka, kc, kalpha, ralpha


def check_node_actions_multi(tree, cfg, draws, report, key="node_actions_multi",
                             label="9x9 grow tree"):
    """`node_actions_multi` on `tree` against its twin (`multi_agrees`),
    timed; its figures go to report[key]. Returns the kernel's actions and
    children (B,K,T)."""
    from boardlaw_tpu_torch.mcts import kernels, search

    mcfg = cfg.mcts_config()
    B, T, A = tree.logits.shape
    K = mcfg.leaves_per_pass
    rands = draws.uniform((B, K, T))
    kw = dict(n_iters=mcfg.solve_iters, accel=mcfg.solve_accel)
    ka, kc, kalpha, ralpha = multi_agrees(tree, rands, kw, f"{label}, {key}")
    args = (tree.logits, tree.n_edge, tree.w_edge, tree.children, rands, tree.c_puct,
            search._q_bounds(tree))
    steps = kernels.solve_steps(*args[:3], tree.c_puct, args[-1], **kw)
    print(f"{key} at (B,T,A)=({B},{T},{A}), row layout (G, J) = "
          f"{kernels.row_layout(A)}: {steps_line(steps, A)}", flush=True)
    k_ms, k_call = both_ms(lambda: kernels.node_actions_multi(*args, **kw), 20)
    r_ms = time_ms(lambda: kernels.node_actions_multi_ref(*args, **kw), 5)
    nbytes = (B * T * (A * row_bytes(tree) + child_bytes(tree, K)) + B * K * T * 4 + B * 4 + 8
              + 2 * B * K * T * 4)
    ops = solve_ops(steps, A) + draw_ops(B * T, A, K)
    report[key] = dict(
        ms=k_call, device_ms=k_ms, plain_ms=r_ms,
        max_abs_err=float((kalpha - ralpha).abs().max()), bytes=nbytes, ops=ops)
    print(f"{key}: kernel {k_ms:.4f} ms on the card ({k_call:.4f} ms a call), "
          f"twin {r_ms:.4f} ms a call (median); "
          f"{nbytes / 1e9:.3f} GB -> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{ops / 1e9:.2f} GFLOP -> f32 bound {ops / F32_FLOPS * 1e3:.4f} ms", flush=True)
    return ka, kc


def split_equals_fused(tree, rands, kw, label):
    """`solve_probs` (both modes) + `sample_children_multi` against
    `node_actions_multi` on one tree and rands (B,K,T): alpha and every draw
    equal. Returns the probs and alpha."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    qb = search._q_bounds(tree)
    rows = (tree.logits, tree.n_edge, tree.w_edge)
    probs = kernels.solve_probs(*rows, tree.c_puct, qb, **kw)
    alpha = kernels.solve_probs(*rows, tree.c_puct, qb, out="alpha", **kw)
    fa, fc, f_alpha = kernels.node_actions_multi(*rows, tree.children, rands, tree.c_puct, qb,
                                                 return_alpha=True, **kw)
    sa, sc = kernels.sample_children_multi(probs, tree.children, rands)
    sync()
    if not torch.equal(alpha, f_alpha):
        fail(f"{label}: solve_probs alpha differs from node_actions_multi's")
    if not (torch.equal(sa, fa) and torch.equal(sc, fc)):
        fail(f"{label}: solve_probs + sample_children_multi differ from node_actions_multi in "
             f"{int((sa != fa).sum())} draws")
    return probs, alpha


def check_solve_probs(tree, cfg, rands, report, key="solve_probs"):
    """`solve_probs` against its twin and, with `sample_children_multi`,
    against `node_actions_multi`, on `tree` with rands (B,K,T); timed, its
    figures to report[key]. Returns the kernel's probs and the twin's."""
    from boardlaw_tpu_torch.mcts import kernels, search

    mcfg = cfg.mcts_config()
    B, T, A = tree.logits.shape
    qb = search._q_bounds(tree)
    rows = (tree.logits, tree.n_edge, tree.w_edge)
    kw = dict(n_iters=mcfg.solve_iters, accel=mcfg.solve_accel)
    probs, alpha = split_equals_fused(tree, rands, kw, f"9x9 scan tree, {key}")
    r_probs, r_alpha = search.node_probs(*rows, tree.c_puct, qb, return_alpha=True, **kw)

    def close(x, ref):  # per row: every lane within rtol 1e-5, atol 1e-7
        return ((x - ref).abs() <= 1e-7 + 1e-5 * ref.abs()).all(-1)

    # the probs evaluation alone: the twin's formula at the kernel's roots
    at_alpha = search.node_probs(*rows, tree.c_puct, qb, fixed_alpha=alpha)
    eval_ok = float(close(probs, at_alpha).float().mean())
    rows_ok = float(close(probs, r_probs).float().mean())
    rel = ((alpha - r_alpha).abs() / r_alpha.abs()).flatten()
    alpha_ok = float((rel <= 1e-5).float().mean())
    err = float((probs - r_probs).abs().max())
    print(f"{key} vs twin at (B,T,A)=({B},{T},{A}): alpha equal to node_actions_multi's on "
          f"every row; probs within rtol 1e-5, atol 1e-7 of the twin's formula at the kernel's "
          f"alpha on {eval_ok:.8f} of rows; of the twin's own solve on {rows_ok:.8f} of rows "
          f"(max |probs| difference {err:.3g}), its alpha within rtol 1e-5 on {alpha_ok:.8f} of "
          f"rows (max rel {float(rel.max()):.3g}): the solve's lane sums run in another order "
          f"than the twin's", flush=True)
    if eval_ok < 1.0:
        fail(f"{key}: probs differ from the twin's formula at the kernel's alpha")
    if alpha_ok < 0.9999 or rows_ok < 0.999:
        fail(f"{key}: the solve disagrees with the twin")

    steps = kernels.solve_steps(*rows, tree.c_puct, qb, **kw)
    print(f"{key} at (B,T,A)=({B},{T},{A}): {steps_line(steps, A)}", flush=True)
    k_ms, k_call = both_ms(lambda: kernels.solve_probs(*rows, tree.c_puct, qb, **kw), 20)
    a_ms, a_call = both_ms(lambda: kernels.solve_probs(*rows, tree.c_puct, qb, out="alpha", **kw),
                           20)
    r_ms = time_ms(lambda: search.node_probs(*rows, tree.c_puct, qb, **kw), 5)
    solve_row = row_bytes(tree)
    nbytes = B * T * A * (solve_row + 4) + B * 4 + 8
    a_bytes = B * T * A * solve_row + B * T * 4 + B * 4 + 8
    ops = solve_ops(steps, A)
    report[key] = dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms, max_abs_err=err, bytes=nbytes,
                       ops=ops)
    print(f"{key}: kernel {k_ms:.4f} ms on the card, {k_call:.4f} ms a call (out='alpha' "
          f"{a_ms:.4f}, {a_call:.4f} ms), twin {r_ms:.4f} ms a call "
          f"(median); {nbytes / 1e9:.3f} GB -> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"(alpha {a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), {ops / 1e9:.2f} GFLOP -> f32 bound "
          f"{ops / F32_FLOPS * 1e3:.4f} ms", flush=True)
    return probs, r_probs


def check_split_kernels(tree, cfg, draws, report, keys=("solve_probs", "sample_children_multi")):
    """`solve_probs` and `sample_children_multi` against their twins and
    against `node_actions_multi`, on one tree and one set of rands; their
    figures go to report[keys[0]] and report[keys[1]]. Returns the
    sampler's child pointers (B,K,T)."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels

    mcfg = cfg.mcts_config()
    B, T, A = tree.logits.shape
    K = mcfg.leaves_per_pass
    rands = draws.uniform((B, K, T))
    probs, r_probs = check_solve_probs(tree, cfg, rands, report, key=keys[0])

    ka, kc = kernels.sample_children_multi(r_probs, tree.children, rands)
    ra, rc = kernels.sample_children_multi_ref(r_probs, tree.children, rands)
    sync()
    if not (torch.equal(ka, ra) and torch.equal(kc, rc)):
        fail(f"sample_children_multi differs from its twin in {int((ka != ra).sum())} draws")
    print(f"sample_children_multi at (B,K,T,A)=({B},{K},{T},{A}): all {ka.numel()} draws and "
          f"child pointers equal to the twin's on the twin's probs; solve_probs + "
          f"sample_children_multi equal to node_actions_multi in every draw", flush=True)

    s_ms, s_call = both_ms(lambda: kernels.sample_children_multi(probs, tree.children, rands), 20)
    rs_ms = time_ms(lambda: kernels.sample_children_multi_ref(probs, tree.children, rands), 5)
    s_bytes = B * T * (A * 4 + child_bytes(tree, K)) + B * K * T * (4 + 4 + 4)
    s_ops = draw_ops(B * T, A, K)
    report[keys[1]] = dict(ms=s_call, device_ms=s_ms, plain_ms=rs_ms, max_abs_err=0.0,
                           bytes=s_bytes, ops=s_ops)
    print(f"{keys[1]}: kernel {s_ms:.4f} ms on the card ({s_call:.4f} ms a call), "
          f"twin {rs_ms:.4f} ms a call (median); "
          f"{s_bytes / 1e9:.3f} GB -> bytes bound {s_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{s_ops / 1e9:.2f} GFLOP -> f32 bound {s_ops / F32_FLOPS * 1e3:.4f} ms", flush=True)
    return kc


def walk_bytes(levels, K, B, R, L):
    """Byte counts of one walk call, each with the K*B*(L+3) int32 outputs
    written once: the useful bytes the bound counts (9 a visited level:
    acts, nxt, the child's terminal flag), and what each design of
    csrc/walk.cu reads: 'block' each env's K acts and nxt rows and its
    terminal row, 'gather' its terminal row and 2 whole 32-byte sectors a
    visited level, 'chase' 3 sectors a visited level."""
    out = K * B * (L + 3) * 4
    return dict(useful=levels * 9 + out, block=B * K * R * 8 + B * R + out,
                gather=levels * 2 * 32 + B * R + out, chase=levels * 3 * 32 + out)


def time_walk(label, terminal, acts, nxt, max_levels, twin_reps=5):
    """`walk` by each design of csrc/walk.cu on acts/nxt as given (a (K,B,R)
    view or (N,R) rows), each bit-equal to the twin in all four outputs, and
    timed. Returns the figures of the design `kernels.walk_design` picks,
    with the others' times under "designs"."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels

    if acts.dim() == 3:
        K, B, R = acts.shape
    else:
        B, R = terminal.shape[0], acts.shape[1]
        K = acts.shape[0] // B
    ref = kernels.walk_ref(terminal, acts, nxt, max_levels)
    sync()
    designs = {}
    for design in kernels.WALK_DESIGNS:
        out = kernels._walk_launch(terminal, acts, nxt, max_levels, design)
        sync()
        for name, o, r in zip(("parents", "actions", "halt_child", "path"), out, ref):
            if not torch.equal(o, r):
                fail(f"{label}: walk ({design!r}) {name} differs from the twin "
                     f"({int((o != r).sum())} entries)")
        designs[design] = both_ms(
            lambda: kernels._walk_launch(terminal, acts, nxt, max_levels, design), 20)
    L = ref[3].shape[1]
    levels = int((ref[3] >= 0).sum())
    depth = int((ref[3] >= 0).sum(1).max())
    r_ms = time_ms(lambda: kernels.walk_ref(terminal, acts, nxt, max_levels), twin_reps)
    nbytes = walk_bytes(levels, K, B, R, L)
    pick = kernels.walk_design(K, R)
    k_ms, k_call = designs[pick]
    times = "; ".join(f"{d!r} {dm:.4f} ms on the card ({cm:.4f} a call)"
                      for d, (dm, cm) in designs.items())
    reads = "; ".join(f"{k} {v / 1e6:.2f} MB -> {v / HBM_BYTES_PER_S * 1e3:.5f} ms"
                      for k, v in nbytes.items())
    print(f"{label}: walk at (K,B,R,L)=({K},{B},{R},{L}), acts/nxt strides "
          f"{tuple(acts.stride())}: all four outputs bit-equal to the twin in every design; "
          f"{levels} levels visited, deepest {depth}; {times}; picked {pick!r}; twin "
          f"{r_ms:.4f} ms a call; bytes (the bound counts the useful ones) {reads}", flush=True)
    return dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms, max_abs_err=0.0,
                bytes=nbytes["useful"], ops=0,
                shape=[K, B, R, L], levels=levels,
                designs={d: dict(device_ms=dm, ms=cm) for d, (dm, cm) in designs.items()})


def check_walk(tree, acts_bkt, nxt_bkt, first_tree, draws, mcfg, report):
    """`walk` at the first and the last grow pass's shapes, on the sampler's
    (B,K,R) buffers as the search hands them: their (K,B,R) views, no copy.
    acts_bkt, nxt_bkt are `node_actions_multi`'s on all T rows of `tree`
    (the last pass's rows); the first pass's are drawn on `first_tree`, a
    tree before its first pass."""
    from boardlaw_tpu_torch.mcts import kernels, search

    R, L = search.pass_shape(mcfg, 0)
    B, K = acts_bkt.shape[:2]
    a_bkr, n_bkr = kernels.node_actions_multi(
        first_tree.logits[:, :R], first_tree.n_edge[:, :R], first_tree.w_edge[:, :R],
        first_tree.children[:, :R], draws.uniform((B, K, R)), first_tree.c_puct,
        search._q_bounds(first_tree), n_iters=mcfg.solve_iters, accel=mcfg.solve_accel)
    first = time_walk("9x9 grow pass 0", first_tree.terminal[:, :R], a_bkr.permute(1, 0, 2),
                      n_bkr.permute(1, 0, 2), L)
    R, L = search.pass_shape(mcfg, mcfg.n_passes - 1)
    last = time_walk(f"9x9 grow pass {mcfg.n_passes - 1}", tree.terminal[:, :R],
                     acts_bkt[:, :, :R].permute(1, 0, 2), nxt_bkt[:, :, :R].permute(1, 0, 2), L)
    report["walk"] = dict(last, first_grow_pass=first)


def backup_prefix_bytes(before, after, paths, leaves):
    """Bytes a `backup_prefix` launch needs: per node it changes, n, w read
    and written and its prew, rewards and seat (12 + 16S); per edge, n_edge
    in its storage type and w_edge read and written; the whole paths array,
    each path entry's action (4), and per walk its leaf, terminal flag,
    value and prew (5 + 8S)."""
    K, B, L = paths.shape
    S = before.w.shape[-1]
    nodes = int((after.n != before.n).sum())
    edges = int((after.n_edge != before.n_edge).sum())
    entries = int((paths >= 0).sum())
    return (nodes * (12 + 16 * S) + edges * (2 * before.n_edge.element_size() + 8)
            + K * B * L * 4 + entries * 4 + K * B * (5 + 8 * S))


def check_backup_prefix(cfg, model, draws, report, key):
    """`backup_prefix` on the inputs of the last grow pass of a real search
    at `cfg`'s envs: n, w, n_edge and w_edge bit-equal to its twin
    `search.backup_paths_prefix` on the card and to a second launch; against
    the twin on the CPU (deterministic mode: its scatters add in entry
    order) n, w and n_edge bit-equal and w_edge within what two orders of
    adding the pass's terms may differ by; timed on the card beside the twin
    on the card and the bytes bound."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    mcfg = cfg.mcts_config()
    K, B, P = mcfg.leaves_per_pass, cfg.n_envs, mcfg.n_passes
    tree = mid_search_tree(cfg, model, draws, B, passes=P - 1)
    captured = []
    launch = kernels.backup_prefix

    def capture(tree, paths, acts, leaves, npv):
        captured.append((tree_copy(tree), paths.clone(), acts, leaves.clone(), npv))
        return launch(tree, paths, acts, leaves, npv)

    R, L = search.pass_shape(mcfg, P - 1)
    kernels.backup_prefix = capture
    try:
        search.simulate_multi(tree, make_eval_fn(model), draws.pass_rands(P - 1, (K, B, R)),
                              mcfg, rows=R, max_levels=L)
    finally:
        kernels.backup_prefix = launch
    del tree
    before, paths, acts, leaves, npv = captured[0]
    label = f"9x9 grow pass {P - 1} (K,B,R,L) = ({K}, {B}, {R}, {L}), T = {before.n.shape[1]}"
    out = kernels.backup_prefix(tree_copy(before), paths, acts, leaves, npv)
    again = kernels.backup_prefix(tree_copy(before), paths, acts, leaves, npv)
    card = search.backup_paths_prefix(tree_copy(before), paths, acts, leaves, npv)
    sync()
    cpu = search.Tree(**{k: (v.cpu() if torch.is_tensor(v) else v)
                         for k, v in before.__dict__.items()})
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        ref = search.backup_paths_prefix(tree_copy(cpu), paths.cpu(), acts.cpu(), leaves.cpu(),
                                         npv)
    finally:
        torch.use_deterministic_algorithms(was)
    cpu_s = time.perf_counter() - t0
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int32: torch.int32}

    def same(x, y):
        return torch.equal(x.view(as_int[x.dtype]), y.view(as_int[y.dtype]))

    differ = [k for k in BACKUP_STATS if not same(getattr(out, k), getattr(card, k))]
    differ += [f"{k} (CPU)" for k in ("n", "w", "n_edge")
               if not same(getattr(out, k).cpu(), getattr(ref, k))]
    # the CPU adds each walk's term to w_edge in turn, the card their sum:
    # two orders of at most K + 1 terms, C_k[seat] - prew[t, seat] each
    term = float(cpu.v.abs().max() + 2 * cpu.prew.abs().max())
    bound = 2 * (K + 1) * 2.0 ** -24 * (cpu.w_edge.abs() + K * term)
    edge_err = (out.w_edge.cpu() - ref.w_edge).abs()
    if not edge_err.le(bound).all():
        differ.append("w_edge (CPU)")
    err = float(edge_err.max())
    if differ:
        fail(f"{label}: {key} differs from its twin in {differ} (w_edge's max |difference| "
             f"from the CPU twin {err:.3g})")
    if not all(same(getattr(out, k), getattr(again, k)) for k in BACKUP_STATS):
        fail(f"{label}: two launches of {key} on one input differ")
    nbytes = backup_prefix_bytes(cpu, ref, paths.cpu(), leaves.cpu())
    scratch = tree_copy(before)
    r_ms = time_ms(lambda: search.backup_paths_prefix(scratch, paths, acts, leaves, npv), 3)
    k_ms, k_call = both_ms(lambda: kernels.backup_prefix(scratch, paths, acts, leaves, npv), 20)
    report[key] = dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms, max_abs_err=err, bytes=nbytes,
                       ops=0)
    print(f"{label}: {key} bit-equal to the twin on the card in n, w, n_edge and w_edge and "
          f"to a second launch, to the CPU twin in n, w and n_edge, w_edge within {err:.3g} of "
          f"it ({int((ref.n - cpu.n).sum()) // npv} visits, {int((paths >= 0).sum())} path "
          f"entries; the twin {cpu_s:.2f} s on the CPU); kernel {k_ms:.4f} ms on "
          f"the card ({k_call:.4f} ms a call), the twin's torch ops {r_ms:.4f} ms a call on the "
          f"card; {nbytes / 1e6:.2f} MB -> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms",
          flush=True)


def check_walk_k1(tree, acts, nxt, report, seed):
    """`walk` at the 6x6 K=1 path's shapes: on the tree's (B,T) rows with
    L = T, as `search.descend` hands them, and on a depth-63 chain (every
    row nxt[t] = t+1, no terminal node), its deepest case."""
    import torch

    B, T = acts.shape
    report["walk"]["k1"] = time_walk("6x6 K=1 tree", tree.terminal, acts, nxt, T, twin_reps=3)
    gen = torch.Generator(device=acts.device).manual_seed(seed)
    c_acts = torch.randint(0, 36, (B, T), generator=gen, device=acts.device, dtype=torch.int32)
    chain = torch.arange(1, T + 1, dtype=torch.int32, device=acts.device).repeat(B, 1)
    chain[:, -1] = -1
    no_term = torch.zeros_like(tree.terminal)
    report["walk"]["k1_chain"] = time_walk(f"depth-{T - 1} chains", no_term, c_acts, chain, T,
                                           twin_reps=1)


def cpu_draws(seed, device):
    """A `Draws` that draws on the CPU, so that both sides of a card-vs-CPU
    check see the same numbers, and hands them over on `device`."""
    from boardlaw_tpu_torch.draws import Draws

    class CpuDraws(Draws):
        def uniform(self, shape, minval=0.0):
            return super().uniform(shape, minval).to(device)

        def normal(self, shape):
            return super().normal(shape).to(device)

        def slots(self, B, T):
            return super().slots(B, T).to(device)

    return CpuDraws(seed, "cpu")


def check_search_cpu_vs_gpu(cfg, model, n_envs=64):
    """A small search on the card (kernels) against the same search on the
    CPU (twins), with the same weights and draws."""
    from boardlaw_tpu_torch import learning
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    B = n_envs
    worlds = learning.mix(hex.Hex.initial(B, cfg.boardsize, device="cpu"), Draws(5, "cpu"), 30)
    mcfg = cfg.mcts_config()
    cpu_model = copy.deepcopy(model).cpu()
    t_cpu = search.mcts(worlds, make_eval_fn(cpu_model), cpu_draws(9, "cpu"), mcfg)
    gworlds = hex.Hex(board=worlds.board.to(DEV), seats=worlds.seats.to(DEV))
    t_gpu = search.mcts(gworlds, make_eval_fn(model), cpu_draws(9, DEV), mcfg)
    same = ((t_cpu.children == t_gpu.children.cpu()).flatten(1).all(1)
            & (t_cpu.n == t_gpu.n.cpu()).all(1)
            & (t_cpu.n_edge == t_gpu.n_edge.cpu()).flatten(1).all(1))
    n_same = int(same.sum())
    w_err = float((t_cpu.w - t_gpu.w.cpu())[same].abs().max())
    print(f"search on the card vs on the CPU ({cfg.boardsize}x{cfg.boardsize}, {B} envs, "
          f"{cfg.width}x{cfg.depth}, K={mcfg.leaves_per_pass}): {n_same}/{B} trees identical "
          f"in children/n/n_edge, max |w| difference on those {w_err:.3g}", flush=True)
    if n_same < B - max(1, B // 16) or w_err > 1e-4:
        fail("the search on the card disagrees with the search on the CPU")


# --------------------------------------------------------------------------
# K=1 kernels
# --------------------------------------------------------------------------

def k1_mid_search_tree(cfg, model, draws, sims):
    """A real K=1 tree after `sims` sims of the K=1 search."""
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    worlds = mix_worlds(cfg.boardsize, cfg.n_envs, draws, 40)
    mcfg = cfg.mcts_config()
    eval_fn = make_eval_fn(model)
    tree = search.build(worlds, mcfg)
    search.initialize(tree, eval_fn(worlds), draws, mcfg, worlds.valid)
    B, T = tree.parents.shape
    for i in range(sims):
        search.simulate(tree, eval_fn, draws.sim_rands(i, (B, T)), mcfg)
    return tree


def node_actions_agrees(tree, rands, label):
    """`node_actions` against its twin on the leading R rows of `tree`, rands
    (B,R), as `multi_agrees` holds `node_actions_multi`: at least 99.99% of
    draws equal, every mismatch between the twin's and the kernel's CDF at
    its boundary lane (+-1e-5), child pointers equal where the actions are,
    alpha within rtol 1e-5 on 99.99% of rows (at most 1e-3). The kernel's
    alpha is its debug output, the root its draws used; it must equal
    `solve_probs`' at the same 16 Newton steps bit for bit (the two share
    the device solve). Returns the kernel's actions and children and the
    largest |kernel - twin| action difference."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    B, R = rands.shape
    A = tree.logits.shape[-1]
    qb = search._q_bounds(tree)
    args = (tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R], tree.children[:, :R],
            rands, tree.c_puct, qb)
    ka, kc, kalpha = kernels.node_actions(*args, return_alpha=True)
    # the twin, `search.node_actions`, with its alpha
    probs, ralpha = search.node_probs(*args[:3], tree.c_puct, qb, return_alpha=True)
    ra, rc = search._sample_children(args[3], probs, rands)
    del probs
    salpha = kernels.solve_probs(*args[:3], tree.c_puct, qb, n_iters=16, accel=False,
                                 out="alpha")
    sync()
    same_root = torch.equal(kalpha, salpha)
    rel = ((kalpha - ralpha).abs() / ralpha.abs()).flatten()
    alpha_ok = float((rel <= 1e-5).float().mean())
    mism = ka != ra
    n_mism = int(mism.sum())
    frac_equal = 1.0 - n_mism / ka.numel()
    err = float((ka - ra).abs().max())
    within_1e5 = within_cdfs = 0
    if n_mism:
        b, t = mism.nonzero(as_tuple=True)
        within_1e5, within_cdfs = boundary_counts(tree, qb, (b, t), rands[b, t], ka[b, t],
                                                  ra[b, t], (ralpha, kalpha))
    print(f"{label}: node_actions vs twin at (B,T,A)=({B},{R},{A}): draws equal "
          f"{frac_equal:.8f} ({n_mism} differ, {within_1e5} of them within 1e-5 of the twin's "
          f"CDF at the boundary lane, {within_cdfs} between the twin's and the kernel's CDF "
          f"there; max |action difference| {err:g}); alpha within rtol 1e-5 on "
          f"{alpha_ok:.8f} of rows (max rel {float(rel.max()):.3g}), equal to solve_probs' "
          f"at 16 Newton steps: {same_root}", flush=True)
    if not same_root:
        fail(f"{label}: node_actions' alpha differs from solve_probs' at the same 16 steps")
    if not bool(((kc == rc) | mism).all()):
        fail(f"{label}: node_actions child pointers differ where the actions agree")
    if frac_equal < 0.9999:
        fail(f"{label}: node_actions: fewer than 99.99% of draws equal the twin's")
    if within_cdfs != n_mism:
        fail(f"{label}: node_actions: a mismatched draw is not explained by a CDF boundary")
    if alpha_ok < 0.9999 or float(rel.max()) > 1e-3:
        fail(f"{label}: node_actions: alpha disagrees with the twin")
    return ka, kc, err


def node_actions_cost(tree, R):
    """Bytes and f32 operations `node_actions` needs on the leading R rows."""
    from boardlaw_tpu_torch.mcts import kernels, search

    B, _, A = tree.logits.shape
    steps = kernels.solve_steps(tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R],
                                tree.c_puct, search._q_bounds(tree))
    nbytes = B * R * (A * row_bytes(tree) + child_bytes(tree, 1)) + B * R * 4 + B * 4 + 8 \
        + 2 * B * R * 4
    return nbytes, solve_ops(steps, A) + draw_ops(B * R, A, 1), steps


def check_node_actions(tree, rands, report, key="node_actions", board="6x6"):
    """`node_actions` on the K=1 tree against its twin, timed on all T rows
    and on the live rows; its figures (all T rows) go to report[key]."""
    from boardlaw_tpu_torch.mcts import kernels, search

    B, T, A = tree.logits.shape
    ka, kc, err = node_actions_agrees(tree, rands, f"{board} K=1 tree, {key}")
    qb = search._q_bounds(tree)
    times = {}
    # all T rows, and the R = tree.sim live rows the search hands over
    for R in (T, tree.sim):
        args = (tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R],
                tree.children[:, :R], rands[:, :R].contiguous(), tree.c_puct, qb)
        k_ms, k_call = both_ms(lambda: kernels.node_actions(*args), 20)
        r_ms = time_ms(lambda: search.node_actions(*args), 5)
        nbytes, ops, steps = node_actions_cost(tree, R)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        times[R] = (k_call, k_ms, r_ms, nbytes, ops)
        print(f"{key} at (B,T,A)=({B},{R},{A}), row layout (G, J) = "
              f"{kernels.row_layout(A)}: {steps_line(steps, A)}; kernel {k_ms:.4f} ms on the "
              f"card ({k_call:.4f} ms a call), twin {r_ms:.4f} ms a call (median); "
              f"{nbytes / 1e9:.3f} GB -> bytes bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {ops / 1e9:.2f} GFLOP -> f32 bound "
              f"{ops / F32_FLOPS * 1e3:.4f} ms; bound {bound:.4f} ms", flush=True)
    k_call, k_ms, r_ms, nbytes, ops = times[T]
    report[key] = dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms, max_abs_err=err, bytes=nbytes,
                       ops=ops)
    return ka, kc


def descend_equals(tree, rands, acts, nxt, label):
    """`descend` against `node_actions` + `walk` (equal on every env) and its
    twin (equal on 99.99% of envs). Returns the walk's parents, halting
    children and paths, and the largest |descend - twin| parent or action
    difference."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    B, T, A = tree.logits.shape
    kp, ka = kernels.descend(tree, rands)
    wp, wa, halt, path = kernels.walk(tree.terminal, acts, nxt, T)
    rp, ra = search.descend_reference(tree, rands)
    sync()
    if not (torch.equal(kp, wp) and torch.equal(ka, wa)):
        fail(f"{label}: descend differs from node_actions + walk on "
             f"{int(((kp != wp) | (ka != wa)).sum())} envs")
    twin_equal = float(((kp == rp) & (ka == ra)).float().mean())
    err = float(torch.maximum((kp - rp).abs(), (ka - ra).abs()).max())
    levels = int((path >= 0).sum())
    print(f"{label}: descend at (B,T,A)=({B},{T},{A}): parents and actions equal to "
          f"node_actions + walk on every env; equal to the twin on {twin_equal:.8f} of envs "
          f"(max |difference| {err:g}); {levels} levels visited, deepest {int((path >= 0).sum(1).max())}", flush=True)
    if twin_equal < 0.9999:
        fail(f"{label}: descend: fewer than 99.99% of walks equal the twin's")
    return wp, halt, path, err


def check_descend(tree, rands, acts, nxt, report, key="descend", board="6x6"):
    """`descend` on the K=1 tree against `node_actions` + `walk` and its
    twin, timed; its figures go to report[key]. Returns the walks' leaves."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    B, T, A = tree.logits.shape
    wp, halt, path, err = descend_equals(tree, rands, acts, nxt, f"{board} K=1 tree, {key}")
    levels = int((path >= 0).sum())
    k_ms, k_call = both_ms(lambda: kernels.descend(tree, rands), 20)
    r_ms = time_ms(lambda: search.descend_reference(tree, rands), 3)
    # each visited level reads its row's solve inputs (`row_bytes` a lane:
    # 10, 8 with bf16 logits, 12 with f32 counts), the drawn child, its rand
    # and the child's terminal flag; per env the root flag, c_puct, two
    # outputs
    nbytes = levels * (A * row_bytes(tree) + child_bytes(tree, 1) + 4 + 1) + B * (1 + 4 + 8) + 8
    steps = kernels.solve_steps(tree.logits, tree.n_edge, tree.w_edge, tree.c_puct,
                                search._q_bounds(tree))
    visited = torch.gather(steps, 1, path.long().clamp_min(0))[path >= 0]
    ops = solve_ops(visited, A) + draw_ops(levels, A, 1)
    report[key] = dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms, max_abs_err=err, bytes=nbytes,
                       ops=ops)
    print(f"{key}: kernel {k_ms:.4f} ms on the card ({k_call:.4f} ms a call), twin "
          f"{r_ms:.4f} ms a call (median); {nbytes / 1e6:.2f} MB "
          f"-> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, {ops / 1e9:.3f} GFLOP -> "
          f"f32 bound {ops / F32_FLOPS * 1e3:.5f} ms", flush=True)
    return torch.where(halt == -1, wp, halt)


def bf16_equals_f32(tree, names, label, rands=None, rands_k=None, kw=None):
    """Each bf16 instantiation in `names` on `tree` (bf16 logits) against the
    f32 kernel on the logits' f32 copy: every output equal, bit for bit.
    rands (B,T) for `node_actions` and `descend`, rands_k (B,K,T) and the
    solve's `kw` for `node_actions_multi` and `solve_probs` (both modes)."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    f32 = replace(tree, logits=tree.logits.float())
    qb = search._q_bounds(tree)
    calls = {
        "node_actions": lambda t: kernels.node_actions(
            t.logits, t.n_edge, t.w_edge, t.children, rands, t.c_puct, qb),
        "node_actions_multi": lambda t: kernels.node_actions_multi(
            t.logits, t.n_edge, t.w_edge, t.children, rands_k, t.c_puct, qb, return_alpha=True,
            **kw),
        "descend": lambda t: kernels.descend(t, rands),
        "solve_probs": lambda t: (
            kernels.solve_probs(t.logits, t.n_edge, t.w_edge, t.c_puct, qb, **kw),
            kernels.solve_probs(t.logits, t.n_edge, t.w_edge, t.c_puct, qb, out="alpha", **kw)),
    }
    for name in names:
        got, want = calls[name](tree), calls[name](f32)
        sync()
        differ = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
        if differ:
            fail(f"{label}: {name} on bf16 logits differs from the f32 kernel on their f32 copy "
                 f"in outputs {differ}")
    print(f"{label}: {', '.join(names)} on bf16 logits bit-equal to the f32 kernels on their "
          f"f32 copy", flush=True)


def f32_copy_ms(name, call, tree):
    """The card's time of `call(t)` (a kernel on a tree `t`) on the bf16
    tree and on its f32 copy, side by side: the two instantiations on the
    same rows."""
    bf16_ms = device_ms(lambda: call(tree), 20)
    f32 = replace(tree, logits=tree.logits.float())
    f32_ms = device_ms(lambda: call(f32), 20)
    print(f"{name} on the same tree: bf16 logits {bf16_ms:.4f} ms on the card, their f32 copy "
          f"{f32_ms:.4f} ms", flush=True)


def copy_free(fn, logits, label):
    """The device memory a call of `fn` allocates at its peak beyond what it
    held and beyond its outputs: fails if that reaches half the bytes of an
    f32 copy of `logits` (the wrapper must read bf16 logits in place).
    Returns the bytes."""
    import torch

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    outs = out if isinstance(out, tuple) else (out,)
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    extra = torch.cuda.max_memory_allocated() - base - out_bytes
    copy = logits.numel() * 4
    print(f"{label}: the call allocates {extra / 1e6:.3f} MB beyond its inputs and its "
          f"{out_bytes / 1e6:.3f} MB of outputs; an f32 copy of the logits would take "
          f"{copy / 1e6:.1f} MB", flush=True)
    if extra >= copy // 2:
        fail(f"{label}: the call allocates {extra} bytes, as much as a copy of the logits")
    return extra


def check_board_layouts(seed, n_envs=1024, sims=20):
    """For each board the repo runs (3, 5, 6, 7, 9, 11: every lane layout of
    the row kernels), a small K=1 tree after `sims` sims, with f32 and with
    bf16 tree logits, on which `node_actions` and `node_actions_multi` agree
    with their twins, `descend` equals `node_actions` + `walk`, both backups
    equal their twin bit for bit from the walks' leaves, and the split pair
    equals `node_actions_multi`; on the bf16 tree each of the four logits'
    kernels equals the f32 kernel on the logits' f32 copy bit for bit."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels

    for tree_dtype in ("float32", "bfloat16"):
        for boardsize in (3, 5, 6, 7, 9, 11):
            cfg = train.make_config(boardsize, 64, 2, n_envs=n_envs, leaves_per_pass=1,
                                    tree_dtype=tree_dtype)
            model = train.build_model(cfg, device=DEV,
                                      generator=torch.Generator().manual_seed(seed + boardsize))
            draws = Draws(seed + boardsize, DEV)
            tree = k1_mid_search_tree(cfg, model, draws, sims)
            B, T, A = tree.logits.shape
            label = (f"{boardsize}x{boardsize} {tree_dtype} tree (A={A}, row layout (G, J) = "
                     f"{kernels.row_layout(A)})")
            rands = draws.uniform((B, T))
            acts, nxt, _ = node_actions_agrees(tree, rands, label)
            wp, halt, _, _ = descend_equals(tree, rands, acts, nxt, label)
            backups_equal(tree, torch.where(halt == -1, wp, halt), label)
            rands_k = draws.uniform((B, 8, T))
            kw = dict(n_iters=6, accel=True)
            multi_agrees(tree, rands_k, kw, label)
            split_equals_fused(tree, rands_k, kw, label)
            print(f"{label}: split pair equal to node_actions_multi in every draw and alpha",
                  flush=True)
            if tree_dtype == "bfloat16":
                bf16_equals_f32(tree, ("node_actions", "node_actions_multi", "descend",
                                       "solve_probs"), label, rands, rands_k, kw)


def check_bf16_kernels(seed, n_envs, report):
    """The bf16 instantiations of the four logits' kernels on real bf16
    trees of the bf16 flagship configuration (bf16 network and tree logits)
    at the main paths' shapes: `node_actions_multi` on the 9x9 grow tree
    after 5 passes (phase 3's rules), `solve_probs` on the 9x9 scan tree
    after 5 passes (phase 3b's: the split pair equal to `node_actions_multi`
    in every draw), `node_actions` and `descend` on the 6x6 K=1 tree after
    30 sims (phase 4's: `descend` equal to `node_actions` + `walk`); each
    timed (and beside it the f32 kernel on the same tree's f32 copy), each
    bit-equal to the f32 kernel on that copy, and each allocating no copy of
    the logits."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels, search

    bf = dict(dtype="bfloat16", tree_dtype="bfloat16")
    cfg9 = train.make_config(9, 512, 4, n_envs=n_envs, **bf)
    model9 = train.build_model(cfg9, device=DEV, generator=torch.Generator().manual_seed(seed))
    mcfg9 = cfg9.mcts_config()
    kw = dict(n_iters=mcfg9.solve_iters, accel=mcfg9.solve_accel)
    K = mcfg9.leaves_per_pass

    draws = Draws(seed + 11, DEV)
    tree = mid_search_tree(cfg9, model9, draws, n_envs, passes=5)
    if tree.logits.dtype != torch.bfloat16:
        fail(f"the bf16 config's tree holds {tree.logits.dtype} logits")
    check_node_actions_multi(tree, cfg9, draws, report, key="node_actions_multi.bf16")
    B, T, A = tree.logits.shape
    rands_k = draws.uniform((B, K, T))
    qb = search._q_bounds(tree)
    bf16_equals_f32(tree, ("node_actions_multi",), "9x9 bf16 grow tree", rands_k=rands_k, kw=kw)
    f32_copy_ms("node_actions_multi", lambda t: kernels.node_actions_multi(
        t.logits, t.n_edge, t.w_edge, t.children, rands_k, t.c_puct, qb, **kw), tree)
    copy_free(lambda: kernels.node_actions_multi(tree.logits, tree.n_edge, tree.w_edge,
                                                 tree.children, rands_k, tree.c_puct, qb, **kw),
              tree.logits, "node_actions_multi.bf16")
    del tree
    torch.cuda.empty_cache()

    cfg9s = scan_config(cfg9)
    tree = mid_search_tree(cfg9s, model9, draws, n_envs, passes=5)
    rands_k = draws.uniform((B, K, tree.logits.shape[1]))
    check_solve_probs(tree, cfg9s, rands_k, report, key="solve_probs.bf16")
    bf16_equals_f32(tree, ("solve_probs",), "9x9 bf16 scan tree", kw=kw)
    qb = search._q_bounds(tree)
    f32_copy_ms("solve_probs", lambda t: kernels.solve_probs(
        t.logits, t.n_edge, t.w_edge, t.c_puct, qb, **kw), tree)
    for out in ("probs", "alpha"):
        copy_free(lambda: kernels.solve_probs(tree.logits, tree.n_edge, tree.w_edge, tree.c_puct,
                                              qb, out=out, **kw),
                  tree.logits, f"solve_probs.bf16, out={out!r}")
    del tree, model9
    torch.cuda.empty_cache()

    cfg6 = train.best_config(6, n_envs=n_envs, **bf)
    model6 = train.build_model(cfg6, device=DEV, generator=torch.Generator().manual_seed(seed))
    draws = Draws(seed + 12, DEV)
    tree = k1_mid_search_tree(cfg6, model6, draws, sims=30)
    B, T = tree.parents.shape
    rands = draws.uniform((B, T))
    acts, nxt = check_node_actions(tree, rands, report, key="node_actions.bf16")
    check_descend(tree, rands, acts, nxt, report, key="descend.bf16")
    bf16_equals_f32(tree, ("node_actions", "descend"), "6x6 bf16 K=1 tree", rands=rands)
    qb = search._q_bounds(tree)
    f32_copy_ms("node_actions", lambda t: kernels.node_actions(
        t.logits, t.n_edge, t.w_edge, t.children, rands, t.c_puct, qb), tree)
    f32_copy_ms("descend", lambda t: kernels.descend(t, rands), tree)
    copy_free(lambda: kernels.node_actions(tree.logits, tree.n_edge, tree.w_edge, tree.children,
                                           rands, tree.c_puct, qb),
              tree.logits, "node_actions.bf16")
    copy_free(lambda: kernels.descend(tree, rands), tree.logits, "descend.bf16")


def tree_copy(tree):
    from boardlaw_tpu_torch.mcts import search

    return search.Tree(**{k: (v.clone() if hasattr(v, "clone") else v)
                          for k, v in tree.__dict__.items()})


BACKUPS = ("backup", "backup_dense")
BACKUP_STATS = ("n", "w", "n_edge", "w_edge")


def backups_equal(tree, leaves, label):
    """Both backup kernels against `search.backup` from `leaves` (B,) int32
    (existing nodes, so every chase is a real path): n, w, n_edge and w_edge
    bit-equal. Returns the levels the chases visited and each kernel's
    largest |kernel - twin| difference over the four statistics."""
    import torch
    from boardlaw_tpu_torch.mcts import kernels, search

    npv = tree.w.shape[-1]
    ref = search.backup(tree_copy(tree), leaves, npv)
    errs = {}
    for name in BACKUPS:
        out = getattr(kernels, name)(tree_copy(tree), leaves, npv)
        sync()
        differ = [k for k in BACKUP_STATS if not torch.equal(getattr(out, k), getattr(ref, k))]
        errs[name] = max(float((getattr(out, k).float() - getattr(ref, k).float()).abs().max())
                         for k in BACKUP_STATS)
        if differ:
            fail(f"{label}: {name} differs from the twin in {differ} (max |difference| "
                 f"{errs[name]:.3g})")
    levels = int((ref.n - tree.n).sum()) // npv
    print(f"{label}: backup and backup_dense bit-equal to the twin in n, w, n_edge and w_edge "
          f"({levels} levels visited)", flush=True)
    return levels, errs


def chain_tree(tree, seed):
    """A tree of `tree`'s shapes in which every env is one chain of depth
    T-1 (node c's parent c-1) with random relations, seats, terminal flags,
    rewards, values and statistics, made on the device from a seed: the
    backups' worst case."""
    import torch

    B, T, S = tree.w.shape
    A = tree.n_edge.shape[-1]
    dev = tree.w.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    relation = ints(A, (B, T))
    relation[:, 0] = -1
    return replace(
        tree, parents=(torch.arange(T, dtype=torch.int32, device=dev) - 1).repeat(B, 1),
        relation=relation, seats=ints(S, (B, T)),
        terminal=torch.rand((B, T), generator=gen, device=dev) < 0.15,
        rewards=normal(B, T, S), v=normal(B, T, S), n=ints(100, (B, T)), w=normal(B, T, S),
        n_edge=ints(100, (B, T, A)).to(tree.n_edge.dtype), w_edge=normal(B, T, A), sim=T)


def time_backups(tree, leaves, label, twin_reps=3, suffix=""):
    """Median ms of each backup kernel and of the twin on `tree`, and the
    bytes they need, keyed by the kernels' names plus `suffix` (".wide"
    for f32 edge counts)."""
    from boardlaw_tpu_torch.mcts import kernels, search

    B, T, S = tree.w.shape
    npv = S
    levels, errs = backups_equal(tree, leaves, label)
    # the level's n_edge read and write in its storage type (2 bytes each
    # in BACKUP_BYTES_PER_LEVEL)
    per_level = BACKUP_BYTES_PER_LEVEL + 2 * (tree.n_edge.element_size() - 2)
    nbytes = levels * per_level + B * (4 + 4 * S)
    scratch = tree_copy(tree)
    r_ms = time_ms(lambda: search.backup(scratch, leaves, npv), twin_reps)
    out = {}
    for name in BACKUPS:
        k_ms, k_call = both_ms(lambda: getattr(kernels, name)(scratch, leaves, npv), 20)
        out[name + suffix] = dict(ms=k_call, device_ms=k_ms, plain_ms=r_ms,
                                  max_abs_err=errs[name], bytes=nbytes, ops=0)
        print(f"{label}: {name} at (B,T,S)=({B},{T},{S}), {levels} levels: kernel {k_ms:.4f} ms "
              f"on the card ({k_call:.4f} ms a call), twin {r_ms:.4f} ms a call (median); "
              f"{nbytes / 1e6:.2f} MB -> bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms",
              flush=True)
    return out


def check_backups(tree, leaves, report, seed, label="6x6 K=1 tree", suffix="", chains=True):
    """Both backup kernels against `search.backup`, bit for bit, and timed:
    on `tree` from `leaves` (the kernel table's row) and, with `chains`, on
    its all-chains twin (`chain_tree`) from every env's deepest node."""
    import torch

    report.update(time_backups(tree, leaves, label, suffix=suffix))
    if not chains:
        return
    chains = chain_tree(tree, seed)
    B, T = chains.parents.shape
    time_backups(chains, torch.full((B,), T - 1, dtype=torch.int32, device=leaves.device),
                 f"all-chains tree (depth {T - 1})", twin_reps=1)


# --------------------------------------------------------------------------
# Paths
# --------------------------------------------------------------------------

def check_record(record, worlds, tree, root_visits, n_nodes):
    import torch

    if not (tree.n[:, 0] == root_visits).all():
        fail(f"root visits {tree.n[:, 0].unique().tolist()}, expected {root_visits}")
    if int(record["n_leaves"].max()) > n_nodes:
        fail("more leaves than nodes")
    logits = record["logits"].float()
    valid = worlds.valid
    if not torch.equal(torch.isneginf(logits), ~valid):
        fail("root logits are not -inf exactly at the invalid actions")
    if not (torch.isfinite(logits[valid]).all() and torch.isfinite(record["v"]).all()
            and torch.isfinite(record["rewards"]).all()):
        fail("non-finite outputs")


def actor_steps(cfg, model, worlds, draws, steps, root_visits):
    from boardlaw_tpu_torch import train

    step_s = []
    for _ in range(steps):
        sync()
        t0 = time.time()
        new_worlds, record, tree = train.actor_record(cfg, model, worlds, draws, return_tree=True)
        sync()
        step_s.append(time.time() - t0)
        check_record(record, worlds, tree, root_visits, cfg.n_nodes)
        worlds = new_worlds
    return worlds, step_s


def steady(times):
    return statistics.median(times[1:]) if len(times) > 1 else times[0]


def host_record(state, slot):
    """The buffer's slot `slot` (a pushed record) as numpy on the host:
    the record's leaves (bf16 ones widened) and the worlds' board and
    seats."""
    out = {k: x[slot].float().cpu().numpy() if x.is_floating_point() else x[slot].cpu().numpy()
           for k, x in state.buffer.items() if k != "worlds"}
    out.update(board=state.buffer["worlds"].board[slot].cpu().numpy(),
               seats=state.buffer["worlds"].seats[slot].cpu().numpy())
    return out


def check_learner(cfg, seed, steps, label, worlds=None, keep=None):
    """make_train, init (on `worlds` if given, else on freshly mixed ones), a
    full warmup and `steps` train steps, with their launch counts. Returns
    the counts, the median train step after the first (s) and the peak
    memory (GB). With a dict `keep`, it is filled for phase 10: the pushed
    record and the aux of the first `keep["steps"]` train steps on the host
    (`records`, `auxes`), the parameters after them (`params`), the step
    times, and the final state and draws."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws

    model, opt, init, warmup, train_step = train.make_train(cfg, device=DEV)
    draws = Draws(seed, DEV)
    if worlds is None:
        state = init(draws)
    else:
        own = copy.deepcopy(model)
        state = train.TrainState(worlds=worlds, buffer=train.empty_buffer(cfg, worlds), ptr=0,
                                 model=own, optimizer=opt(own.parameters()), step=0)
    sync()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    expected = search_launches(cfg.mcts_config())

    def drive():
        nonlocal state
        t0 = time.time()
        state = warmup(state, draws)
        sync()
        print(f"{label}: warmup of {cfg.buffer_len} actor steps {time.time() - t0:.2f} s",
              flush=True)
        auxes = []
        for i in range(steps):
            sync()
            slot = state.ptr
            t0 = time.time()
            state, aux = train_step(state, draws)
            sync()
            step_s.append(time.time() - t0)
            auxes.append(aux)
            if keep is not None and i < keep["steps"]:
                keep.setdefault("records", []).append(host_record(state, slot))
                keep.setdefault("auxes", []).append({k: float(v) for k, v in aux.items()})
                keep["params"] = {k: p.detach().cpu().numpy()
                                  for k, p in state.model.named_parameters()}
        return auxes

    counts, auxes = run_path(label, {k: v * (cfg.buffer_len + steps) for k, v in expected.items()},
                             drive)
    bad = [k for aux in auxes for k, v in aux.items() if not torch.isfinite(v).all()]
    if bad:
        fail(f"{label}: non-finite aux {sorted(set(bad))}")
    moved = any(not torch.equal(a, b) for a, b in zip(model.parameters(), state.model.parameters()))
    if not moved or state.step != steps or state.ptr != steps % cfg.buffer_len:
        fail(f"{label}: parameters did not move or step/ptr did not advance")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last = {k: round(float(v), 6) for k, v in auxes[-1].items()}
    print(f"{label} ({cfg.n_envs} envs): train steps {step_s} s, median after the first "
          f"{steady(step_s):.4f} s/step, peak memory {peak_gb:.2f} GB; last aux {last}",
          flush=True)
    if keep is not None:
        keep.update(state=state, draws=draws, step_s=step_s)
    return counts, steady(step_s), peak_gb


def scan_config(cfg9):
    """The 9x9 scan path: every pass over all 65 rows, the split solve and
    sampler kernels (the JAX dry-run's production-shaped search)."""
    return replace(cfg9, grow_passes=False, solve_kernel="probs", sample_kernel=True)


def same_trees(tree, ref):
    """Per env: children, n and n_edge equal."""
    return ((tree.children == ref.children).flatten(1).all(1) & (tree.n == ref.n).all(1)
            & (tree.n_edge == ref.n_edge).flatten(1).all(1))


def check_scan_routes(cfg, model, worlds, seed):
    """One 9x9 scan search per other route of `simulate_multi` from the same
    worlds and draws, each held against `cfg`'s route (the split kernels)."""
    import torch
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    mcfg = cfg.mcts_config()
    eval_fn = make_eval_fn(model)
    B, T = worlds.n_envs, search.tree_size(mcfg)
    ref = search.mcts(worlds, eval_fn, Draws(seed, DEV), mcfg)
    root_visits = 2 * mcfg.leaves_per_pass * mcfg.n_passes
    counts = {}
    for name, kw in (("'alpha' + torch 'matmul' sampler", dict(solve_kernel="alpha",
                                                              sample_kernel=False)),
                     ("'ops' + sampler kernel", dict(solve_kernel="ops")),
                     ("'fused'", dict(solve_kernel="fused")),
                     ("einsum backup", dict(backup_mode="einsum")),
                     ("warm solve on 'ops'", dict(solve_kernel="ops", warm_solve=True))):
        vcfg = replace(mcfg, **kw)
        t0 = time.time()
        c, tree = run_path(f"the 9x9 scan search, {name}", search_launches(vcfg),
                           lambda: search.mcts(worlds, eval_fn, Draws(seed, DEV), vcfg))
        secs = time.time() - t0
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        if not (tree.n[:, 0] == root_visits).all():
            fail(f"scan route {name}: root visits {tree.n[:, 0].unique().tolist()}")
        if not (torch.isfinite(tree.w).all() and torch.isfinite(tree.w_edge).all()
                and int(tree.children.max()) < T):
            fail(f"scan route {name}: non-finite stats or a child pointer >= T")
        if vcfg.warm_solve:
            print(f"scan route {name} ({secs:.3f} s per search): root visits {root_visits}, stats "
                  f"finite, child pointers below T (its alpha is another root, so its trees "
                  f"are not compared)", flush=True)
            continue
        same = same_trees(tree, ref)
        n_diff = int((~same).sum())
        w_err = float((tree.w - ref.w)[same].abs().max())
        print(f"scan route {name} ({secs:.3f} s per search): {n_diff} of {B} envs differ from "
              f"the split-kernel route in children/n/n_edge; max |w| difference on the others "
              f"{w_err:.3g}", flush=True)
        if n_diff > 0.01 * B or w_err > 1e-4:
            fail(f"the scan route {name} disagrees with the split-kernel route")
    return counts


def check_train_step_cpu_vs_gpu(seed, dtype="float32", rtol=1e-4):
    """A tiny train step on the card (kernels) against the same step on the
    CPU (twins), from one warmed-up state and the same draws, with the
    network and the tree logits in `dtype`: losses to `rtol`."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.mcts.search import _map_world

    cfg = train.make_config(5, 32, 2, nodes=17, n_envs=64, buffer_len=4, mix_steps=20,
                            dtype=dtype, tree_dtype=dtype)
    _, _, init, warmup, _ = train.make_train(cfg, device="cpu")
    draws = cpu_draws(seed, "cpu")
    state = warmup(init(draws), draws)
    gpu = copy.deepcopy(state)
    gpu.model.to(DEV)
    gpu.optimizer = train.make_optimizer(cfg, gpu.model.parameters())
    gpu.worlds = _map_world(state.worlds, lambda x: x.to(DEV))
    gpu.buffer = {k: (_map_world(v, lambda x: x.to(DEV)) if k == "worlds" else v.to(DEV))
                  for k, v in state.buffer.items()}
    _, caux = train.train_step(cfg, state, cpu_draws(seed + 1, "cpu"))
    _, gaux = train.train_step(cfg, gpu, cpu_draws(seed + 1, DEV))
    sync()
    worst = max(abs(float(gaux[k]) - float(caux[k])) / max(abs(float(caux[k])), 1e-12)
                for k in ("loss.policy", "loss.value", "loss.total"))
    print(f"train step on the card vs on the CPU (5x5, 64 envs, K=1, {dtype} network and tree "
          f"logits): losses {[round(float(gaux[k]), 7) for k in ('loss.policy', 'loss.value')]} "
          f"vs {[round(float(caux[k]), 7) for k in ('loss.policy', 'loss.value')]}, worst "
          f"relative difference {worst:.3g} (tolerance {rtol:g})", flush=True)
    if worst > rtol:
        fail(f"the {dtype} train step on the card disagrees with the step on the CPU")


# the bf16 train step on the card against the CPU (phase 5f): the losses'
# relative tolerance. Measured on the H100: 6.8e-8 (the float32 step's:
# 1.9e-7); bf16 products sum in other orders on the two devices, so a
# rounding of one activation may flip, hence the margin.
BF16_STEP_RTOL = 1e-3


def check_bf16_paths(args, worlds9, worlds6, f32_figures, card):
    """Phase 5i: the bf16 flagship configuration (bf16 network and tree
    logits) on its paths, each with its launch counts: `--steps` 9x9 actor
    steps (K=8 grow, `node_actions_multi.bf16`), the learner (a full warmup
    and `--steps` train steps, aux finite, parameters moved), one 6x6 K=1
    actor step (`node_actions.bf16`), and one 9x9 scan actor step
    (`solve_probs.bf16`). Prints the step seconds and peak memory beside the
    float32 ones. Returns the launches of the three bf16 instantiations."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws

    bf = dict(dtype="bfloat16", tree_dtype="bfloat16")
    cfg9 = train.make_config(9, 512, 4, n_envs=args.envs, **bf)
    mcfg9 = cfg9.mcts_config()
    model9 = train.build_model(cfg9, device=DEV, generator=torch.Generator().manual_seed(args.seed))
    root_visits = 2 * mcfg9.leaves_per_pass * mcfg9.n_passes
    draws = Draws(args.seed, DEV)
    figures = {}
    launches = {}

    torch.cuda.reset_peak_memory_stats()
    c, (_, step_s) = run_path(
        f"{args.steps} bf16 9x9 actor steps",
        {k: v * args.steps for k, v in search_launches(mcfg9).items()},
        lambda: actor_steps(cfg9, model9, worlds9, draws, args.steps, root_visits))
    launches["node_actions_multi.bf16"] = c["node_actions_multi.bf16"]
    figures["actor"] = (steady(step_s), torch.cuda.max_memory_allocated() / 1e9)
    print(f"bf16 actor step (9x9, 512x4, {cfg9.n_envs} envs, 64 nodes, K=8, bf16 network and "
          f"tree logits): steps {step_s} s, median after the first {steady(step_s):.4f} s/step, "
          f"peak memory {figures['actor'][1]:.2f} GB; card: {card}", flush=True)
    _, *figures["learner"] = check_learner(cfg9, args.seed, args.steps, "the bf16 9x9 learner",
                                           worlds=worlds9)

    cfg6 = train.best_config(6, n_envs=args.envs, **bf)
    mcfg6 = cfg6.mcts_config()
    model6 = train.build_model(cfg6, device=DEV, generator=torch.Generator().manual_seed(args.seed))
    sims = mcfg6.n_nodes - 1
    torch.cuda.reset_peak_memory_stats()
    c, (_, step_s) = run_path(
        "one bf16 6x6 K=1 actor step", search_launches(mcfg6),
        lambda: actor_steps(cfg6, model6, worlds6, draws, 1, 2 * sims))
    launches["node_actions.bf16"] = c["node_actions.bf16"]
    figures["k1 actor"] = (step_s[0], torch.cuda.max_memory_allocated() / 1e9)

    cfg9s = scan_config(cfg9)
    mcfg9s = cfg9s.mcts_config()
    torch.cuda.reset_peak_memory_stats()
    c, (_, step_s) = run_path(
        "one bf16 9x9 scan actor step", search_launches(mcfg9s),
        lambda: actor_steps(cfg9s, model9, worlds9, draws, 1, root_visits))
    launches["solve_probs.bf16"] = c["solve_probs.bf16"]
    figures["scan actor"] = (step_s[0], torch.cuda.max_memory_allocated() / 1e9)

    for name, (secs, peak) in figures.items():
        f_secs, f_peak = f32_figures[name]
        print(f"{name} step, bf16 network and tree logits: {secs:.4f} s, peak memory "
              f"{peak:.2f} GB; float32: {f_secs:.4f} s, {f_peak:.2f} GB; card: {card}",
              flush=True)
    return launches


# --------------------------------------------------------------------------
# Planted-value searches and the training entry point
# --------------------------------------------------------------------------

# the search routes of phase 6a: MCTSConfig fields over the game's own
VALIDATION_ROUTES = {
    "K=1": {},
    "K=8 grow": dict(leaves_per_pass=8, grow_passes=True),
    "K=8 scan, split kernels": dict(leaves_per_pass=8, solve_kernel="probs", sample_kernel=True),
}

# the JAX test's planted 3x3 position (tests/test_mcts.py test_planted_game)
PLANTED_HEX = """
    wb.
    bw.
    wb.
    """
# the share of copies of the planted game whose root policy must keep the
# JAX test's inequalities: they hold for the JAX test's one key, not for
# every draw (the JAX search misses them in 1 of 512 copies at K=1 on the
# CPU test's draws, and the port in the same copies)
PLANTED_SHARE = 0.95


def validation_games(n_envs, device):
    """name -> (world, n_nodes, MCTSConfig fields, analytic root value or
    None): the search cases of the JAX package's tests/test_mcts.py."""
    from boardlaw_tpu_torch.envs import validation as V

    return {
        "Win": (V.Win.initial(n_envs, device=device), 3, {}, [1.0]),
        "WinnerLoser": (V.WinnerLoser.initial(n_envs, device=device), 3, {}, [1.0, -1.0]),
        "All": (V.All.initial(n_envs, length=3, device=device), 15, {"noise_eps": 0.0}, [1 / 8]),
        "All, two seats": (V.All.initial(n_envs, n_seats=2, length=3, device=device), 15,
                           {"noise_eps": 0.0}, [1 / 8, 1 / 8]),
        "dilemma": (V.SequentialMatrix.dilemma(n_envs, device=device), 15, {}, None),
    }


def search_cpu_vs_card(world, agent, mcfg, seed, label):
    """`mcfg`'s search of the CPU world `world` on the card (kernels) and on
    the CPU (twins), with the draws of one CPU generator: children, parents,
    relation (the sampled actions), n and n_edge bit-equal, w, w_edge and
    the root policy's probabilities to 1e-6."""
    import torch
    from boardlaw_tpu_torch.mcts import search

    t_cpu = search.mcts(world, agent, cpu_draws(seed, "cpu"), mcfg)
    t_gpu = search.mcts(search._map_world(world, lambda x: x.to(DEV)), agent,
                        cpu_draws(seed, DEV), mcfg)
    differ = [k for k in ("children", "parents", "relation", "n", "n_edge")
              if not torch.equal(getattr(t_cpu, k), getattr(t_gpu, k).cpu())]
    p_cpu, p_gpu = (search.root(t)["logits"].exp().cpu() for t in (t_cpu, t_gpu))
    errs = {"w": (t_cpu.w - t_gpu.w.cpu()).abs().max(),
            "w_edge": (t_cpu.w_edge - t_gpu.w_edge.cpu()).abs().max(),
            "root policy": (p_cpu - p_gpu).abs().max()}
    err = max(float(v) for v in errs.values())
    if differ or not err <= 1e-6 or not torch.equal(p_cpu == 0, p_gpu == 0):
        fail(f"{label}: the search on the card differs from the CPU's in {differ}, values by "
             f"{err:.3g}")
    return err


def check_validation_searches(seed, n_envs):
    """Phase 6a: every planted-value game by every search route at `n_envs`
    envs, each with its launch counts; the root value against the analytic
    one (to 1e-5) and every root's visits; then the same search on 64 envs
    on the card and on the CPU. Returns the launches of every kernel."""
    import torch
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import validation as V
    from boardlaw_tpu_torch.mcts import search

    counts = {}
    worst = 0.0
    small = validation_games(64, "cpu")
    for game, (world, n_nodes, kw, value) in validation_games(n_envs, DEV).items():
        for route, rkw in VALIDATION_ROUTES.items():
            mcfg = search.MCTSConfig(n_nodes=n_nodes, **kw, **rkw)
            label = f"{game}, {route}"
            t0 = time.time()
            c, tree = run_path(f"the planted-value search {label}", search_launches(mcfg),
                               lambda: search.mcts(world, V.ProxyAgent(), Draws(seed, DEV), mcfg))
            secs = time.time() - t0
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            visits = world.n_seats * mcfg.leaves_per_pass * mcfg.n_passes
            if not (tree.n[:, 0] == visits).all():
                fail(f"{label}: root visits {tree.n[:, 0].unique().tolist()}, expected {visits}")
            v0 = search.root(tree)["v"]
            err = 0.0
            if value is not None:
                err = float((v0 - torch.tensor(value, device=DEV)).abs().max())
                if err > 1e-5:
                    fail(f"{label}: root value off the analytic {value} by {err:.3g}")
            small_err = search_cpu_vs_card(small[game][0], V.ProxyAgent(), mcfg, seed + 1, label)
            worst = max(worst, small_err)
            print(f"{label} ({n_envs} envs, {n_nodes} nodes, {secs:.3f} s): root value "
                  f"{v0[0].tolist()} (analytic {value}, max error {err:.3g}); 64 envs on the "
                  f"card equal to the CPU's (values within {small_err:.3g})", flush=True)
    print(f"phase 6a launches by kernel: {counts}; the card against the CPU: topology and "
          f"visits bit-equal on every search, values within {worst:.3g}", flush=True)
    return counts


def check_planted_hex(seed, n_envs):
    """Phase 6b: the JAX test's planted 3x3 Hex game (`hex.from_string`,
    `RandomAgent`, 63 nodes, c_puct 1, K=1) in `n_envs` copies, each with its
    own draws: the JAX test's inequalities on the root policy in at least
    `PLANTED_SHARE` of them, and 64 copies on the card equal to the CPU's.
    Returns the launches."""
    import torch
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex, validation as V
    from boardlaw_tpu_torch.mcts import search

    def copies(n, device):
        one = hex.from_string(PLANTED_HEX, device=device)
        return hex.Hex(board=one.board.repeat(n, 1, 1), seats=one.seats.repeat(n))

    mcfg = search.MCTSConfig(n_nodes=63, c_puct=1.0, noise_eps=0.0)
    world = copies(n_envs, DEV)
    t0 = time.time()
    c, tree = run_path("the planted 3x3 Hex search", search_launches(mcfg),
                       lambda: search.mcts(world, V.RandomAgent(), Draws(seed, DEV), mcfg))
    secs = time.time() - t0
    probs = search.root(tree)["logits"].exp()
    holds = (probs[:, 2] > probs[:, 8]) & (probs[:, 5] > probs[:, 7])
    share = float(holds.float().mean())
    err = search_cpu_vs_card(copies(64, "cpu"), V.RandomAgent(), mcfg, seed + 1, "planted Hex")
    print(f"planted 3x3 Hex ({n_envs} copies, 63 nodes, K=1, {secs:.3f} s): probs[2] > probs[8] "
          f"and probs[5] > probs[7] in {int(holds.sum())} of {n_envs} copies ({share:.6f}; "
          f"needed {PLANTED_SHARE}); mean root policy over cells 2, 5, 8 "
          f"{probs[:, [2, 5, 8]].mean(0).tolist()}; 64 copies on the card equal to the CPU's "
          f"(values within {err:.3g})", flush=True)
    if share < PLANTED_SHARE:
        fail(f"the planted game's inequalities hold in only {share:.4f} of the copies")
    return c


# the channels `train.run`'s loop writes every step (boardlaw_tpu/train.py's)
RUN_CHANNELS = ("loss.total", "loss.policy", "loss.value", "grad.norm", "step.std",
                "corr.terminal", "kl-div.prior", "rel-entropy.policy", "v.target.mean",
                "policy-conc", "mcts-n-leaves", "noise-scale", "wins.seat-0", "wins.seat-1",
                "sample-rate.actor", "step-rate.learner", "count.samples", "n-trajs")


def check_train_run(args, card, bare_step_s):
    """Phase 7: `train.run(9, 512, 4, max_steps=10)` on the card (the full
    9x9 config of `make_config`, f32, `--envs` envs) in a temporary run
    root, then `resume=` that run to 12 steps; the latest payload's step and
    sample count after each, `walk` and `node_actions_multi` launched in
    both, a fresh `load_state_dict` of the last payload equal to it bit for
    bit, the loop's stats channels and `count.samples` by the numpy reader.
    Prints the set-up seconds, the median s/step inside `run` beside the
    bare `train_step`'s (phase 5d), a snapshot write's ms and the peak
    memory. Runs in the caller's run root. Returns the launches of the two
    calls and the run."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.pavlov import runs, stats, storage

    B = args.envs
    cfg = train.make_config(9, 512, 4, n_envs=B)
    per_search = search_launches(cfg.mcts_config())
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    for label, steps, kw in (("train.run(9, 512, 4, max_steps=10)", 10, {}),
                             ("train.run(..., resume=run, max_steps=12)", 12, "resume")):
        n_actor = cfg.buffer_len + (steps if kw != "resume" else 2)
        if kw == "resume":
            kw = {"resume": run}
        t0 = time.time()
        c, run = run_path(label, {k: v * n_actor for k, v in per_search.items()},
                          lambda: train.run(9, 512, 4, n_envs=B, max_steps=steps, **kw))
        secs = time.time() - t0
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        payload = storage.load_latest(run)
        if payload["agent"]["step"] != steps or payload["n_samples"] != steps * B:
            fail(f"{label}: latest step {payload['agent']['step']}, samples "
                 f"{payload['n_samples']}, expected {steps} and {steps * B}")
        print(f"{label}: {secs:.2f} s in all; latest step {payload['agent']['step']}, "
              f"{payload['n_samples']:.0f} samples", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if runs.list_runs() != [run]:
        fail(f"resume made another run: {runs.list_runs()}")

    # a fresh model and optimizer on the card take the payload bit for bit
    model = train.build_model(cfg, device=DEV)
    state = train.TrainState(worlds=None, buffer=None, ptr=0, model=model,
                             optimizer=train.make_optimizer(cfg, model.parameters()), step=0)
    train.load_state_dict(state, payload["agent"])
    saved = payload["agent"]
    same = all(torch.equal(v.cpu(), saved["params"][k]) for k, v in model.state_dict().items())
    opt = state.optimizer.state_dict()["state"]
    same &= all(torch.equal(opt[i][k].cpu(), saved["opt"]["state"][i][k])
                for i in saved["opt"]["state"] for k in ("step", "exp_avg", "exp_avg_sq"))
    if not same or state.step != 12 or len(opt) != len(list(model.parameters())):
        fail("load_state_dict of the last payload does not reproduce it bit for bit")

    missing = [c for c in RUN_CHANNELS if c not in stats.channels(run)]
    if missing:
        fail(f"train.run wrote no stats channels {missing}")
    total = float(stats.rows(run, "count.samples")["total"].sum())
    if total != 12 * B:
        fail(f"count.samples reads {total}, expected {12 * B}")
    step_rows = stats.rows(run, "time.step")["total"]
    inside = statistics.median(list(step_rows[1:10]) + list(step_rows[11:]))
    setup = {k: stats.rows(run, f"time.setup.{k}")["x"].tolist() for k in ("init", "warmup")}
    snap = stats.rows(run, "time.save.snapshot")
    snap_ms = [1e3 * float(x) for x in snap["total"]] if snap is not None else []
    latest = [1e3 * float(x) for x in stats.rows(run, "time.save.latest")["total"]]
    ckpt_mb = os.path.getsize(runs.run_dir(run) / "storage.latest.pkl") / 1e6
    print(f"train.run on the card (9x9, 512x4, {B} envs, K=8 grow, f32): set-up seconds "
          f"init (mix) {setup['init']}, warmup {setup['warmup']}; s/step inside run, "
          f"median of the steps after each call's first {inside:.4f} (steps "
          f"{[round(float(x), 4) for x in step_rows]}); bare train_step (phase 5d) "
          f"{bare_step_s:.4f}, so run adds {100 * (inside / bare_step_s - 1):.2f}%; snapshot "
          f"writes {len(snap_ms)}, ms {[round(x, 2) for x in snap_ms]}; latest writes ms "
          f"{[round(x, 2) for x in latest]}; checkpoint {ckpt_mb:.2f} MB; peak memory "
          f"{peak_gb:.2f} GB; card: {card}", flush=True)
    return launches, run


# --------------------------------------------------------------------------
# Phase 8: the wide tree (n_nodes > 127)
# --------------------------------------------------------------------------

def k1_config(cfg, n_nodes, **kw):
    """`cfg` (9x9 512x4) with the K=1 search of `n_nodes` nodes."""
    return replace(cfg, n_nodes=n_nodes, leaves_per_pass=1, grow_passes=False, **kw)


def timed_search(label, cfg, model, worlds, seed, card):
    """One search under `cfg`'s `MCTSConfig` through `run_path`, with its
    launch counts (`search_launches`); prints its seconds and peak
    memory."""
    import torch
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import search
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    mcfg = cfg.mcts_config()
    eval_fn = make_eval_fn(model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    counts, tree = run_path(label, search_launches(mcfg),
                            lambda: search.mcts(worlds, eval_fn, Draws(seed, DEV), mcfg))
    secs = time.time() - t0
    B, T, A = tree.children.shape
    root = mcfg.leaves_per_pass * mcfg.n_passes * 2
    if not (tree.n[:, 0] == root).all():
        fail(f"{label}: root visits {tree.n[:, 0].unique().tolist()}, expected {root}")
    print(f"{label}: {secs:.3f} s a search ({B} envs, T={T}, children {tree.children.dtype}, "
          f"n_edge {tree.n_edge.dtype}, logits {tree.logits.dtype}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}", flush=True)
    return counts, tree


def add_counts(total, counts):
    for k, v in counts.items():
        if v:
            total[k] = total.get(k, 0) + v


def wide_k1_kernels(tree, cfg, draws, report, seed, tag):
    """The K=1 kernels on a wide K=1 tree (`tag` ".wide" or ".mixed") by the
    rules of phase 4: `node_actions` and `descend` against their twins and
    each other, `walk` by every design, both backups bit-equal to their twin
    (the `.wide` instantiations where the counts are f32, the compact ones
    at T = 128), `node_actions_multi` at K = 8 on the same rows; then the
    bf16 instantiations on the tree's bf16 copy, bit-equal to the f32
    kernels on its f32 copy and timed. Returns the launches of `HELD`'s
    instantiations."""
    import torch

    before = read_counts()
    B, T = tree.parents.shape
    rands = draws.uniform((B, T))
    acts, nxt = check_node_actions(tree, rands, report, key=f"node_actions{tag}", board="9x9")
    leaves = check_descend(tree, rands, acts, nxt, report, key=f"descend{tag}", board="9x9")
    report["walk"][f"k1_T{T}"] = time_walk(f"9x9 K=1 tree, T={T}", tree.terminal, acts, nxt, T,
                                           twin_reps=1)
    # bf16 counts (T = 128) take the compact backups, whose figures are
    # phase 4's: here they are checked only
    wide = tree.n_edge.dtype == torch.float32
    check_backups(tree, leaves, report if wide else {}, seed, label=f"9x9 K=1 tree, T={T}",
                  suffix=".wide" if wide else "", chains=False)
    k8 = replace(cfg, leaves_per_pass=8)
    check_node_actions_multi(tree, k8, draws, report, key=f"node_actions_multi{tag}",
                             label=f"9x9 K=1 tree, T={T}, K=8 draws")
    del acts, nxt, leaves
    torch.cuda.empty_cache()

    bf = replace(tree, logits=tree.logits.bfloat16())
    del tree
    torch.cuda.empty_cache()
    acts, nxt = check_node_actions(bf, rands, report, key=f"node_actions{tag}.bf16", board="9x9")
    check_descend(bf, rands, acts, nxt, report, key=f"descend{tag}.bf16", board="9x9")
    rands_k = draws.uniform((B, 8, T))
    check_node_actions_multi(bf, k8, draws, report, key=f"node_actions_multi{tag}.bf16",
                             label=f"9x9 K=1 tree, T={T}, K=8 draws")
    bf16_equals_f32(bf, ("node_actions", "descend", "node_actions_multi"),
                    f"9x9 K=1 tree, T={T}, bf16 logits", rands, rands_k,
                    dict(n_iters=6, accel=True))
    return held_launches(before)


def check_wide_tree(args, card, report):
    """Phase 8: the wide tree at full width, the 9x9 512x4 FCModel with
    random weights from `--seed`. The searches, each with its launch counts:
    K=1 at n_nodes=256 (int32 children, f32 counts) at `--envs` envs; K=1
    at n_nodes=128 (int32, bf16); one `make_config(9, 512, 4, nodes=512)` grow
    actor step (T = 513) and one scan actor step through `solve_probs` +
    `sample_children_multi`, at half the envs (the twins' temporaries at
    T = 513 do not fit beside a 32,768-env tree); then, at 4,096 envs, the
    bf16-logits searches on wide trees and the one-pass K = 127 search
    (T = 128) of `node_actions_multi`'s mixed instantiations. The kernels
    against their twins on mid-search trees by the rules of phases 3, 3b
    and 4; the sampler's child pointers above 256 exact; 64 envs (16 at 256
    nodes) on the card against the CPU's search. Returns the searches'
    launches by instantiation, and those of the kernels no search launches
    (`HELD`) in the checks against their twins."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws

    B = args.envs
    cfg = train.make_config(9, 512, 4, n_envs=B)
    model = train.build_model(cfg, device=DEV, generator=torch.Generator().manual_seed(args.seed))
    launches = {}
    draws = Draws(args.seed + 20, DEV)
    worlds = mix_worlds(9, B, draws, 40)

    # K=1 at 256 nodes
    t0 = time.time()
    cfg256 = k1_config(cfg, 256)
    counts, tree = timed_search("9x9 K=1 search, n_nodes=256", cfg256, model, worlds,
                                args.seed + 21, card)
    add_counts(launches, counts)
    del tree
    tree = k1_mid_search_tree(cfg256, model, draws, sims=120)
    held = wide_k1_kernels(tree, cfg256, draws, report, args.seed + 22, ".wide")
    del tree
    torch.cuda.empty_cache()
    # 16 envs: the CPU's twins take some 45 s over 64 envs of 256 nodes
    check_search_cpu_vs_gpu(cfg256, model, n_envs=16)

    # K=1 at 128 nodes: int32 children, bf16 counts
    t0 = lap("phase 8, K=1 at 256 nodes", t0)
    cfg128 = k1_config(cfg, 128)
    counts, tree = timed_search("9x9 K=1 search, n_nodes=128", cfg128, model, worlds,
                                args.seed + 23, card)
    add_counts(launches, counts)
    del tree
    tree = k1_mid_search_tree(cfg128, model, draws, sims=80)
    add_counts(held, wide_k1_kernels(tree, cfg128, draws, report, args.seed + 24, ".mixed"))
    del tree, worlds
    torch.cuda.empty_cache()
    check_search_cpu_vs_gpu(cfg128, model)

    # the grow and scan searches at 512 nodes (T = 513)
    t0 = lap("phase 8, K=1 at 128 nodes", t0)
    B2 = B // 2
    cfg512 = train.make_config(9, 512, 4, nodes=512, n_envs=B2)
    mcfg512 = cfg512.mcts_config()
    draws = Draws(args.seed + 25, DEV)
    worlds = mix_worlds(9, B2, draws, 40)
    torch.cuda.reset_peak_memory_stats()
    root = 2 * mcfg512.leaves_per_pass * mcfg512.n_passes
    c, (_, step_s) = run_path("one 9x9 grow actor step, nodes=512",
                              search_launches(mcfg512),
                              lambda: actor_steps(cfg512, model, worlds, draws, 1, root))
    add_counts(launches, c)
    print(f"grow actor step (9x9, 512x4, {B2} envs, nodes=512, T=513, K=8): {step_s[0]:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}",
          flush=True)
    cfg512s = scan_config(cfg512)
    torch.cuda.reset_peak_memory_stats()
    c, (_, step_s) = run_path("one 9x9 scan actor step, nodes=512",
                              search_launches(cfg512s.mcts_config()),
                              lambda: actor_steps(cfg512s, model, worlds, draws, 1, root))
    add_counts(launches, c)
    print(f"scan actor step (9x9, 512x4, {B2} envs, nodes=512, T=513, K=8, solve_probs + "
          f"sample_children_multi): {step_s[0]:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}", flush=True)
    del worlds
    torch.cuda.empty_cache()

    tree = mid_search_tree(cfg512, model, draws, B2, passes=40)
    ka, kc = check_node_actions_multi(tree, cfg512, draws, report, key="node_actions_multi.wide")
    report["walk"]["grow_T513"] = time_walk(
        "9x9 grow tree, T=513", tree.terminal, ka.permute(1, 0, 2), kc.permute(1, 0, 2),
        search_levels(mcfg512))
    del ka, kc
    bf = replace(tree, logits=tree.logits.bfloat16())
    del tree
    torch.cuda.empty_cache()
    check_node_actions_multi(bf, cfg512, draws, report, key="node_actions_multi.wide.bf16")
    rands_k = draws.uniform((B2, 8, bf.children.shape[1]))
    bf16_equals_f32(bf, ("node_actions_multi",), "9x9 grow tree, T=513, bf16 logits",
                    rands_k=rands_k, kw=dict(n_iters=6, accel=True))
    del bf, rands_k
    torch.cuda.empty_cache()

    tree = mid_search_tree(cfg512s, model, draws, B2, passes=40)
    kc = check_split_kernels(tree, cfg512s, draws, report,
                             keys=("solve_probs.wide", "sample_children_multi.wide"))
    n_high = int((kc > 256).sum())
    print(f"sample_children_multi.wide: {n_high} draws' child pointers above 256, each equal to "
          f"the twin's", flush=True)
    if n_high == 0:
        fail("the T=513 scan tree gave no child pointer above 256 to check")
    bf = replace(tree, logits=tree.logits.bfloat16())
    del tree, kc
    torch.cuda.empty_cache()
    rands_k = draws.uniform((B2, 8, bf.children.shape[1]))
    check_solve_probs(bf, cfg512s, rands_k, report, key="solve_probs.wide.bf16")
    bf16_equals_f32(bf, ("solve_probs",), "9x9 scan tree, T=513, bf16 logits",
                    kw=dict(n_iters=6, accel=True))
    del bf, rands_k
    torch.cuda.empty_cache()
    check_backup_prefix(cfg512, model, draws, report, "backup_prefix.wide")
    for c in (cfg512, cfg512s):
        check_search_cpu_vs_gpu(c, model)

    # the bf16-logits searches on wide trees, and K = 127 at T = 128
    t0 = lap("phase 8, grow and scan at 512 nodes", t0)
    B3 = min(4096, B)
    draws = Draws(args.seed + 26, DEV)
    worlds = mix_worlds(9, B3, draws, 40)
    bf = dict(tree_dtype="bfloat16")
    small = [("K=1, n_nodes=256, bf16 logits", k1_config(cfg, 256, **bf)),
             ("K=1, n_nodes=128, bf16 logits", k1_config(cfg, 128, **bf)),
             ("K=127, n_nodes=128 (T=128, one pass)",
              replace(cfg, n_nodes=128, leaves_per_pass=127)),
             ("K=127, n_nodes=128, bf16 logits",
              replace(cfg, n_nodes=128, leaves_per_pass=127, **bf)),
             ("grow, nodes=512, bf16 logits", replace(cfg512, **bf)),
             ("scan, nodes=512, bf16 logits", replace(cfg512s, **bf))]
    for label, c in small:
        counts, tree = timed_search(f"9x9 search, {label}", replace(c, n_envs=B3), model, worlds,
                                    args.seed + 27, card)
        add_counts(launches, counts)
        del tree
    del worlds
    torch.cuda.empty_cache()
    lap("phase 8, the bf16-logits and K=127 searches", t0)
    return launches, held


def search_levels(mcfg):
    """The walk levels of the last pass of a grow search."""
    from boardlaw_tpu_torch.mcts import search

    return search.pass_shape(mcfg, mcfg.n_passes - 1)[1]


# --------------------------------------------------------------------------
# Phase 9: evaluation on the card
# --------------------------------------------------------------------------

def counted_path(name, must, fn):
    """Drive one evaluation path with every count at 0 before; fail unless
    each kernel in `must` launched at least once (a game's plies, and so
    its searches, depend on the moves). Returns the counts and the output."""
    reset_counts()
    sync()
    out = fn()
    sync()
    counts = read_counts()
    print(f"launches on {name}: { {k: v for k, v in counts.items() if v} }", flush=True)
    missing = [k for k in must if counts[k] == 0]
    if missing:
        fail(f"{name}: {missing} launched no time")
    return counts, out


def eval_figures(label, results, secs, card):
    """Checks `common.evaluate`'s results (every game ended, wins sum to
    games) and prints games/s and moves/s."""
    games = sum(r["games"] for r in results)
    moves = sum(r["moves"] for r in results)
    wins = sum(sum(r["wins"]) for r in results)
    print(f"{label}: {results}; {games:.0f} games, {moves:.0f} moves in {secs:.2f} s: "
          f"{games / secs:.2f} games/s, {moves / secs:.1f} moves/s; card: {card}", flush=True)
    if wins != games:
        fail(f"{label}: wins {wins} do not sum to games {games}")
    return games


def check_live_arena_run(n_envs, card):
    """`train.run(3, 8, 1, max_steps=3, arena=True)` (1,024 envs, an
    8-step buffer, 500 mix steps) with the live arena's child spawned at a 0.5 s
    interval; its last step waits for the child's first `elo-arena` row
    (up to 300 s). The child's ledger and stats, and its end with the run.
    Returns the run."""
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.arena import live
    from boardlaw_tpu_torch.pavlov import runs, stats

    children = []
    spawn, step = live.run, train.train_step

    def fast_spawn(run_name, ladder, device):
        children.append(spawn(run_name, interval=0.5, ladder=ladder, device=device))
        return children[-1]

    def waiting_step(cfg, state, draws):
        out = step(cfg, state, draws)
        if state.step == 3:
            run = runs.list_runs()[-1]
            deadline = time.monotonic() + 300
            while "elo-arena" not in stats.channels(run) and time.monotonic() < deadline:
                if not children[0].is_alive():
                    fail("the live arena's child died")
                time.sleep(0.2)
        return out

    live.run, train.train_step = fast_spawn, waiting_step
    t0 = time.time()
    try:
        run = train.run(3, 8, 1, max_steps=3, arena=True, n_envs=n_envs, buffer_len=8,
                        mix_steps=500)
    finally:
        live.run, train.train_step = spawn, step
    trials = live.ledger_trials(run)
    games = float((trials.black_wins + trials.white_wins).sum())
    print(f"train.run(3, 8, 1, max_steps=3, arena=True): {time.time() - t0:.2f} s; the child "
          f"wrote {games:.0f} games to the ledger ({trials.rows()}) and elo-arena rows "
          f"{stats.rows(run, 'elo-arena').tolist()}; child alive after the run: "
          f"{children[0].is_alive()}, exit code {children[0].exitcode}; card: {card}", flush=True)
    if games == 0 or "elo-arena" not in stats.channels(run) or children[0].is_alive():
        fail("the live arena's child wrote no ledger or elo-arena rows, or outlived the run")
    return run


def check_evaluation(args, card, run, figures):
    """Phase 9: evaluation on the card, on phase 7's run. Agents of its
    latest and first snapshot (K=1, n_nodes=128: the mixed tree), one search
    each on 256 envs; `common.evaluate` of the two over 256 envs until every
    game ends, on the live arena's K=8 grow route at n_nodes=128 (T = 129,
    the wide tree); `neural.evaluate`'s league of those two and
    `rollout-4`; two `RollingArena.play` rounds on the run (ledger, activelo
    on the card, `elo-arena`); `train.run(3, 8, 1, arena=True)`; the exact
    3x3 oracle against itself (black always wins) and a 3x3 wide-tree agent
    (K=1, n_nodes=200) against it; one external-ladder game against the
    bundled GTP engine. Returns the launches of the phase's paths; the
    league's games/s go to `figures["league"]`."""
    import numpy as np
    import torch
    from boardlaw_tpu_torch.arena import common, live, neural, perfect
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.pavlov import stats

    launches = {}
    t0 = time.time()
    grow = dict(live.SEARCH)
    E = min(256, args.envs)
    world = common.worlds(run, E)

    # the snapshots' agents, K=1 at 128 nodes
    latest, first = common.agent(run, n_nodes=128), common.agent(run, idx=0, n_nodes=128)
    if latest is None or first is None:
        fail("arena.common.agent found no checkpoint in phase 7's run")

    def both():
        return [ag(world, Draws(args.seed + 30, DEV), eval=True)["actions"]
                for ag in (latest, first)]

    c, acts = run_path(f"the snapshots' agents (K=1, n_nodes=128, {E} envs)",
                       {"node_actions.mixed": 2 * 127, "walk": 2 * 127, "backup": 2 * 127},
                       both)
    add_counts(launches, c)
    for a in acts:
        if not world.valid[torch.arange(E, device=DEV), a.long()].all():
            fail("an arena agent chose an invalid move")

    # common.evaluate over 256 envs, the live arena's grow route at 128 nodes
    g_latest = common.agent(run, n_nodes=128, **grow)
    g_first = common.agent(run, idx=0, n_nodes=128, **grow)
    t0 = time.time()
    c, results = counted_path(
        f"common.evaluate (9x9, {E} envs, K=8 grow, n_nodes=128)",
        ("node_actions_multi.wide", "walk"),
        lambda: common.evaluate(world, {"latest": g_latest, "first": g_first},
                                draws=Draws(args.seed + 31, DEV)))
    add_counts(launches, c)
    if eval_figures("common.evaluate, latest vs first snapshot", results, time.time() - t0,
                    card) != E:
        fail("common.evaluate: not every game ended")

    t0 = lap("phase 9, the agents and common.evaluate", t0)
    # the league
    league = {"latest": g_latest, "first": g_first, **live.rollout_ladder((4,))}
    t0 = time.time()
    c, trials = counted_path("neural.evaluate (a league of 3, 9x9)",
                             ("node_actions_multi.wide", "walk", "node_actions"),
                             lambda: neural.evaluate(9, league, n_envs_per=8, seed=args.seed))
    add_counts(launches, c)
    secs = time.time() - t0
    games = float((trials.black_wins + trials.white_wins).sum())
    figures["league"] = games / secs
    print(f"neural.evaluate league: {trials.rows()}; {games:.0f} games in {secs:.2f} s: "
          f"{games / secs:.2f} games/s; card: {card}", flush=True)
    if len(trials) != 6 or games != 6 * 8:
        fail(f"the league played {games} games over {len(trials)} matchups, expected 48 over 6")

    t0 = lap("phase 9, the league", t0)
    # the rolling arena on the run: two rounds
    arena = live.RollingArena(run, search_kwargs=grow)
    t0 = time.time()
    with stats.to_run(run):
        rels = [arena.play(), arena.play()]
    trials = live.ledger_trials(run)
    games = float((trials.black_wins + trials.white_wins).sum())
    print(f"RollingArena: two rounds in {time.time() - t0:.2f} s, elo {rels}, ledger "
          f"{trials.rows()}, posterior mu {arena.soln.mu.tolist()} over {arena.soln.names}; "
          f"card: {card}", flush=True)
    if games != 2 * arena.n_envs or not all(np.isfinite(r) for r in rels) \
            or "elo-arena" not in stats.channels(run):
        fail("RollingArena: the ledger, the posterior or elo-arena is wrong")

    t0 = lap("phase 9, RollingArena", t0)
    # train.run with its live arena
    run3 = check_live_arena_run(min(1024, args.envs), card)

    t0 = lap("phase 9, train.run(arena=True)", t0)
    # the exact 3x3 oracle, and a wide-tree agent against it
    solver = perfect.Solver(3)
    res = common.evaluate(hex.Hex.initial(8, 3), {"p": perfect.PerfectAgent(solver),
                                                  "q": perfect.PerfectAgent(solver, 1)})
    print(f"PerfectAgent against itself on 3x3: {res}; {solver.states_solved()} states solved "
          f"in {time.time() - t0:.2f} s", flush=True)
    if [r["wins"] for r in res] != [(4.0, 0.0), (4.0, 0.0)]:
        fail("perfect play on 3x3: black does not win every game")
    agent3 = common.agent(run3, n_nodes=200)
    c, cal = counted_path("perfect.calibrate_exact (3x3, K=1, n_nodes=200)",
                          ("node_actions.wide", "walk"),
                          lambda: perfect.calibrate_exact(agent3, 3, n_envs=16))
    add_counts(launches, c)
    print(f"a 3x3 wide-tree agent (K=1, n_nodes=200) against perfect play: win rate "
          f"{cal['winrate']:.3f} over {cal['games']:.0f} games", flush=True)
    if cal["games"] != 16:
        fail("calibrate_exact: not every game ended")

    t0 = lap("phase 9, perfect play", t0)
    # one external-ladder game against the bundled GTP engine
    ladder = live.external_ladder(randoms=(0.0,), max_proxies=2)
    try:
        c, res = counted_path("common.evaluate against the GTP engine (3x3)", ("walk",),
                              lambda: common.evaluate(hex.Hex.initial(2, 3),
                                                      {"net": agent3, **ladder}))
    finally:
        for a in ladder.values():
            a.close()
    add_counts(launches, c)
    eval_figures("external ladder (3x3, K=1 n_nodes=200 vs the gtphex engine)", res,
                 time.time() - t0, card)
    return launches


# --------------------------------------------------------------------------
# Phase 10: data parallelism, the process pools and utils/ on the card
# --------------------------------------------------------------------------

# phase 10a: the share of envs whose pushed record may differ from the
# single process's in a step. A roundoff difference (a block's GEMMs, the
# reduced gradient's order of summation) can move a draw at a CDF boundary;
# that env's search, and its game after, go their own way. An env agrees
# where its integer leaves (n_leaves, terminal, board, seats) are equal,
# its -inf are where they were, its f32 leaves (v, rewards) within
# DP_RECORD_ATOL (phase 5h's rule) and its bf16 leaves (logits, prior)
# within one bf16 step (rtol 2^-7, atol 1e-5, tests/test_torch_train.py's).
DP_DIVERGED_SHARE = 0.01
DP_RECORD_ATOL = 1e-4
# the aux, and the parameters after the two steps
DP_AUX_RTOL = 1e-4
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-4, 1e-6


def dp_rank(mesh, cfg, seed, steps, reps):
    """Phase 10a's rank: `make_train(cfg, mesh=mesh)`, init, the full warmup
    and `steps` train steps through the sharded view of `Draws(seed)`, its
    launch counts over all of them, each step's pushed record (its block)
    and aux, the parameters after; then the two collectives alone, both
    ranks at once: the gradient's flat all-reduce and the q-bounds' (2,)
    MAX, and the whole batch's draws of a train step (`step_draws`), median
    ms of `reps` calls each. Returns numpy and floats."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels

    cuda = mesh.device.type == "cuda"

    def sync_rank():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    if cuda:
        kernels.build()  # the parent built it: this loads it
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _, _, init, warmup, train_step = train.make_train(cfg, mesh=mesh)
    draws = Draws(seed, mesh.device).shard(mesh.rank, mesh.size)
    reset_counts()
    t0 = time.time()
    state = init(draws)
    sync_rank()
    init_s, t0 = time.time() - t0, time.time()
    state = warmup(state, draws)
    sync_rank()
    warmup_s = time.time() - t0
    records, auxes, step_s = [], [], []
    for _ in range(steps):
        slot = state.ptr
        sync_rank()
        t0 = time.time()
        state, aux = train_step(state, draws)
        sync_rank()
        step_s.append(time.time() - t0)
        records.append(host_record(state, slot))
        auxes.append({k: float(v) for k, v in aux.items()})
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(mesh.device) / 1e9 if cuda else 0.0

    def timed_ms(fn):
        times = []
        for _ in range(reps + 1):
            mesh.all_reduce(torch.zeros(1, device=mesh.device))  # line the ranks up
            sync_rank()
            t0 = time.perf_counter()
            fn()
            sync_rank()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times[1:])

    grads = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
    bounds = torch.zeros(2, device=mesh.device)
    return {"counts": counts, "init_s": init_s, "warmup_s": warmup_s, "step_s": step_s,
            "draw_ms": timed_ms(lambda: step_draws(cfg, Draws(seed + 1, mesh.device))),
            "records": records, "auxes": auxes, "peak_gb": peak_gb,
            "params": {k: p.detach().cpu().numpy() for k, p in state.model.named_parameters()},
            "grad_ms": timed_ms(lambda: mesh.all_reduce(grads)), "n_grad": grads.numel(),
            "q_bounds_ms": timed_ms(lambda: mesh.all_reduce(bounds, "max"))}


def step_draws(cfg, draws):
    """Every number a K>1 train step of `cfg` draws for all its envs (what
    each rank of phase 10a generates, to keep its block): the Dirichlet
    noise, each pass's uniforms, the action's Gumbel noise and the slots."""
    from boardlaw_tpu_torch.mcts import search

    mcfg = cfg.mcts_config()
    B, A, K = cfg.n_envs, cfg.boardsize ** 2, mcfg.leaves_per_pass
    draws.dirichlet((B, A), 4)
    for p in range(mcfg.n_passes):
        draws.pass_rands(p, (K, B, search.pass_shape(mcfg, p)[0]))
    draws.gumbel((B, A))
    draws.slots(B, cfg.buffer_len)


def dp_records_agree(got, want, label):
    """The ranks' blocks of a step's pushed record against the single
    process's, env by env (`DP_DIVERGED_SHARE`'s rule). Returns the
    envs that differ: by integer leaves, by float leaves only."""
    import numpy as np

    B = len(want["n_leaves"])
    by_ints = np.zeros(B, bool)
    for k in ("n_leaves", "terminal", "board", "seats"):
        by_ints |= (got[k] != want[k]).reshape(B, -1).any(1)
    by_floats = np.zeros(B, bool)
    for k, (rtol, atol) in (("v", (0, DP_RECORD_ATOL)), ("rewards", (0, DP_RECORD_ATOL)),
                            ("logits", (2 ** -7, 1e-5)), ("prior", (2 ** -7, 1e-5))):
        g, w = got[k].reshape(B, -1), want[k].reshape(B, -1)
        fin = np.isfinite(w)
        with np.errstate(invalid="ignore"):  # -inf - -inf, masked by fin
            off = (np.isneginf(g) != np.isneginf(w)) | (
                fin & ~(np.abs(g - w) <= atol + rtol * np.abs(np.where(fin, w, 0))))
        by_floats |= off.any(1)
    n_ints, n_floats = int(by_ints.sum()), int((by_floats & ~by_ints).sum())
    if n_ints + n_floats > DP_DIVERGED_SHARE * B:
        fail(f"{label}: {n_ints} of {B} envs differ from the single process's in integer "
             f"leaves and {n_floats} more in float leaves (at most a share of "
             f"{DP_DIVERGED_SHARE})")
    return n_ints, n_floats


def check_data_parallel(args, card, cfg, ref):
    """Phase 10a: two ranks spawned on the one card over gloo
    (`distributed.launch(..., device="cuda:0")`), 16,384 envs each of
    `cfg` (32,768), run `init`, the full warmup and 2 train steps through
    the sharded view of `Draws(seed)`, held against phase 5d's single
    process on the same draws (`ref`, `check_learner`'s `keep`): each
    rank's launches (8 of `walk` and `node_actions_multi` an actor step),
    the ranks' parameters bit-equal, the pushed records by
    `dp_records_agree`, the aux to `DP_AUX_RTOL`, the parameters to
    `DP_PARAM_RTOL`/`DP_PARAM_ATOL`. Prints the s per train step beside
    5d's, the collectives' ms, the ms of a step's draws and each rank's
    peak memory. Returns the launches of both ranks together."""
    import numpy as np
    from boardlaw_tpu_torch.parallel import distributed

    steps, world = 2, 2
    t0 = time.time()
    ranks = distributed.launch(dp_rank, world, device=f"{DEV}:0" if DEV == "cuda" else DEV,
                               args=(cfg, args.seed, steps, 10), timeout=900)
    wall = time.time() - t0
    want = {k: v * (cfg.buffer_len + steps) for k, v in search_launches(cfg.mcts_config()).items()}
    total = {}
    for r, out in enumerate(ranks):
        nonzero = {k: v for k, v in search_counts(out["counts"]).items() if v}
        print(f"launches on rank {r} of 2 (init, {cfg.buffer_len} warmup and {steps} train "
              f"steps): {nonzero} (expected {want})", flush=True)
        if DEV == "cuda" and nonzero != want:
            fail(f"rank {r}: kernel launches {nonzero}, expected {want}")
        add_counts(total, out["counts"])

    for k, p in ranks[0]["params"].items():
        if not np.array_equal(p, ranks[1]["params"][k]):
            fail(f"the ranks' parameter {k} differs: they applied different updates")
    for i in range(steps):
        got = {k: np.concatenate([out["records"][i][k] for out in ranks])
               for k in ranks[0]["records"][i]}
        n_ints, n_floats = dp_records_agree(got, ref["records"][i], f"train step {i + 1}")
        aux, ref_aux = ranks[0]["auxes"][i], ref["auxes"][i]
        if aux != ranks[1]["auxes"][i]:
            fail(f"train step {i + 1}: the ranks' aux differ")
        rel = {k: abs(aux[k] - v) / max(abs(v), 1e-6) for k, v in ref_aux.items()}
        bad = {k: (aux[k], ref_aux[k]) for k, v in rel.items()
               if abs(aux[k] - ref_aux[k]) > DP_AUX_RTOL * abs(ref_aux[k]) + 1e-6}
        print(f"train step {i + 1}: envs whose record differs from the single process's: "
              f"{n_ints} by integer leaves, {n_floats} more by float leaves, of "
              f"{len(got['n_leaves'])}; aux largest relative difference "
              f"{max(rel.values()):.3g} ({max(rel, key=rel.get)})", flush=True)
        if bad:
            fail(f"train step {i + 1}: aux beyond rtol {DP_AUX_RTOL}: {bad}")
    err = 0.0
    for k, p in ranks[0]["params"].items():
        w = ref["params"][k]
        if not np.allclose(p, w, rtol=DP_PARAM_RTOL, atol=DP_PARAM_ATOL):
            fail(f"parameter {k} after {steps} steps differs from the single process's")
        err = max(err, float(np.abs(p - w).max()))
    step_s = [out["step_s"] for out in ranks]
    print(f"2 ranks on one card (9x9, 512x4, {cfg.n_envs} envs, {cfg.n_envs // world} a rank, "
          f"gloo): "
          f"{wall:.2f} s in all; init (mix) {[round(o['init_s'], 2) for o in ranks]} s, warmup "
          f"{[round(o['warmup_s'], 2) for o in ranks]} s; s per train step by rank "
          f"{step_s}, single process (5d) {ref['step_s'][:steps]}; gradient all-reduce of "
          f"{ranks[0]['n_grad']} f32 {[round(o['grad_ms'], 3) for o in ranks]} ms, q-bounds "
          f"all-reduce {[round(o['q_bounds_ms'], 4) for o in ranks]} ms a pass "
          f"({cfg.mcts_config().n_passes} a search); a train step's draws for all envs "
          f"{[round(o['draw_ms'], 3) for o in ranks]} ms; peak memory by rank "
          f"{[round(o['peak_gb'], 2) for o in ranks]} GB; parameters within {err:.3g} of the "
          f"single process's; card: {card}", flush=True)
    return total


def check_run_refuses():
    """Phase 10b: `train.run(9, 512, 4, n_devices=2)` with fewer cards
    visible raises ValueError naming their count and leaves no run."""
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.pavlov import runs

    before = runs.list_runs()
    visible = torch.cuda.device_count()
    n = max(2, visible + 1)
    try:
        train.run(9, 512, 4, n_devices=n)
    except ValueError as e:
        if f"{visible} visible" not in str(e):
            fail(f"train.run(n_devices={n}) raised {e!r}, which names no card count")
        print(f"train.run(9, 512, 4, n_devices={n}) with {visible} card(s): ValueError({e})",
              flush=True)
    else:
        fail(f"train.run(n_devices={n}) ran on {visible} card(s)")
    if runs.list_runs() != before:
        fail("the refused train.run left a run behind")


def league_loader(spec, device=None):
    """Phase 10c's loader: a snapshot of phase 7's run searching as the
    live arena does (K=8 grow, 128 nodes), or the rollout-4 agent."""
    from boardlaw_tpu_torch.arena import common, live

    if spec == "rollout-4":
        return live.rollout_ladder((4,))["rollout-4"]
    run, idx = spec
    agent = common.agent(run, idx, device=device, n_nodes=128, **live.SEARCH)
    if agent is None:
        raise RuntimeError(f"no checkpoint {idx} in {run}")
    return agent


def check_evaluate_parallel(args, card, run, league_rate):
    """Phase 10c: phase 9's league (phase 7's latest and first snapshots
    and rollout-4) by `neural.evaluate_parallel` over 2 spawned workers on
    the card, in chunks of 2 agents (2 jobs): every ordered pair plays 8
    games. Prints games/s beside phase 9's `neural.evaluate`."""
    from boardlaw_tpu_torch.arena import neural

    specs = {"latest": (run, None), "first": (run, 0), "rollout-4": "rollout-4"}
    t0 = time.time()
    trials = neural.evaluate_parallel(9, specs, loader=league_loader, n_envs_per=8,
                                      chunk_size=2, max_workers=2, seed=args.seed,
                                      device=None if DEV == "cuda" else DEV, timeout=600)
    secs = time.time() - t0
    games = float((trials.black_wins + trials.white_wins).sum())
    print(f"neural.evaluate_parallel league over 2 workers on the card: {trials.rows()}; "
          f"{games:.0f} games in {secs:.2f} s: {games / secs:.2f} games/s (phase 9's "
          f"neural.evaluate {league_rate:.2f}); card: {card}", flush=True)
    if len(trials) != 6 or games != 6 * 8:
        fail(f"evaluate_parallel played {games} games over {len(trials)} matchups, "
             f"expected 48 over 6")


def check_utils_on_card(cfg, keep, card):
    """Phase 10d: one more train step of phase 5d's state (10a's shape,
    one process) under `utils.profiling.trace`, whose chrome trace must
    name the kernels `walk` and `node_actions_multi`, between two
    `utils.memory.Monitor` snapshots (a positive delta: the step's aux
    stay); `memory.usage` gives the card's total."""
    import json
    import tempfile
    import torch
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.utils import memory, profiling

    state, draws = keep["state"], keep["draws"]
    monitor = memory.Monitor(DEV)
    used, total = memory.usage(DEV)
    if DEV == "cuda" and total != torch.cuda.get_device_properties(0).total_memory:
        fail(f"memory.usage gives {total} bytes for the card")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as d:
        monitor.snap("before the step")
        t0 = time.time()
        with profiling.trace(d) as prof:
            state, aux = train.train_step(cfg, state, draws)
        secs = time.time() - t0
        monitor.snap("after the step")
        trace_mb = os.path.getsize(prof.path) / 1e6
        events = json.loads(prof.path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in names if k in n)[:2] for k in ("walk", "node_actions_multi")}
    rows = monitor.rows()
    print(f"profiling.trace of one train step ({cfg.n_envs} envs): {secs:.2f} s with the "
          f"trace, {trace_mb:.1f} MB, {len(events)} events, {len(names)} kernel names, among "
          f"them {found}; memory.Monitor {rows}; memory.usage {used} of {total} bytes; card: "
          f"{card}", flush=True)
    if DEV == "cuda" and not all(found.values()):
        fail(f"the trace names no kernel of {[k for k, v in found.items() if not v]}")
    if rows[1]["delta"] <= 0 and DEV == "cuda":
        fail(f"memory.Monitor: no positive delta around the step ({rows})")
    return aux


# --------------------------------------------------------------------------
# Phase 11: the results database and the scaling study on the card
# --------------------------------------------------------------------------

# phase 11b's study: boardsize, ladder, envs and steps. 3 steps, not 4: a
# fourth step of the 512x4 run crosses the 9x9 FlopsStorer's first savepoint
# (1e12 FLOPs), whose snapshot would add a fifth agent to the league
STUDY = dict(boardsize=9, sizes="64:2,512:4", envs=4096, steps=3, k=8, test_k=8, envs_per=4,
             league_envs=1024, dtype="float32")
# the parameters of the 9x9 512x4 FCModel (phase 7's), each noise-scale row's
FLAGSHIP_PARAMS = 1_176_150


class Searches:
    """Counts the `MCTSAgent` searches made inside the block, by their
    leaves per pass."""

    def __enter__(self):
        from boardlaw_tpu_torch.mcts import search

        self.calls = []
        self._search, self._call = search, search.MCTSAgent.__call__

        def counted(agent, world, draws=None, eval=False, **overrides):
            self.calls.append(agent.cfg.leaves_per_pass)
            return self._call(agent, world, draws, eval=eval, **overrides)

        search.MCTSAgent.__call__ = counted
        return self

    def __exit__(self, *exc):
        self._search.MCTSAgent.__call__ = self._call


def per_search(label, counts, searches):
    """Fails unless each search of `searches` launched its route's kernels
    once a pass: 8 of `walk`, `node_actions_multi` and `backup_prefix` a K=8
    grow search at 64 nodes, 63 of `node_actions`, `walk` and `backup` a K=1
    search, nothing else."""
    k8 = sum(1 for k in searches if k == 8)
    k1 = sum(1 for k in searches if k == 1)
    want = {"walk": 8 * k8 + 63 * k1, "node_actions_multi": 8 * k8, "backup_prefix": 8 * k8,
            "node_actions": 63 * k1, "backup": 63 * k1}
    got = {k: v for k, v in search_counts(counts).items() if v}
    print(f"{label}: {k8} K=8 grow searches, {k1} K=1 searches; launches {got}", flush=True)
    if len(searches) != k8 + k1 or got != {k: v for k, v in want.items() if v}:
        fail(f"{label}: launches {got}, expected {want} for {k8} K=8 and {k1} K=1 searches")


def check_results_database(args, card, run, slice_launches):
    """Phase 11: the results database (`sql`) and the scaling study on the
    card, on phase 7's run, with `BOARDLAW_DB` in a temporary directory and
    neither pandas nor matplotlib used. a. `sql.refresh()` over phases 7 and
    9's run root: one agent row per snapshot. b. `torch_scaling_study`'s
    `train` stage (`STUDY`: 9x9, 64x2 and 512x4, 4,096 envs, 3 steps, two
    snapshots registered a run at two FLOP points as the JAX test does),
    its `evaluate` stage (K=8 grow leagues, every ordered pair of the four
    agents, a rerun adding nothing), `elos.solve` on the `trial_query` rows
    and `data.fit_model` on (flops, boardsize, elo) arrays; games/s, the
    fit's seconds and RMSE. c. `best.std_available(9)` and
    `best.evaluate(9, n_envs=256, rounds=1)` through `sql_agent`/`sql_world`.
    d. `noisescales.evaluate` on phase 7's latest snapshot (64 nodes, c
    1/16, perf, 1,024 envs, 16 steps): three finite rows over 1,176,150
    parameters, a second call adding nothing; the collection's and the
    gradients' seconds. e. `mohex_calibration.play_out` of `PerfectAgent`
    against itself on 3x3 (black wins every game), then `calibrate` of a
    snapshot of phase 9's 3x3 run against tests/gtp_stub.py as the MoHex
    binary, with `calibrations` and `best_agent`. Each part's launches go
    to `slice_launches`."""
    import argparse
    import tempfile

    import numpy as np
    import torch
    from boardlaw_tpu_torch import elos, mohex, noisescales, sql, train
    from boardlaw_tpu_torch.arena import best, mohex_calibration, perfect
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.pavlov import runs, storage
    from boardlaw_tpu_torch.scaling import data
    from scripts import torch_scaling_study as study

    old_db = os.environ.get("BOARDLAW_DB")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-db-") as tmp:
        os.environ["BOARDLAW_DB"] = os.path.join(tmp, "database.sql")
        try:
            # a. the registry
            t0 = time.time()
            sql.refresh()
            ags = sql.agent_query()
            snaps = {(r, i) for r in runs.list_runs()
                     if "boardsize" in runs.info(r).get("params", {})
                     for i in storage.snapshots(r)}
            print(f"sql.refresh: {len(sql.query('select * from runs'))} runs, {len(snaps)} "
                  f"snapshots, {len(ags)} agents ({[(r.run[-10:], r.idx, r.test_nodes) for r in ags]})",
                  flush=True)
            if len(ags) != len(snaps) or {(r.run, r.idx) for r in ags} != snaps \
                    or run not in set(ags.run):
                fail("sql.refresh: not one agent row per snapshot")

            # b. the study: train, league, Elos, fit
            t0 = lap("phase 11a, sql.refresh", t0)
            sargs = argparse.Namespace(seed=args.seed, device=DEV, **STUDY)
            before = set(runs.list_runs())
            cfg = train.make_config(9, 512, 4, n_envs=STUDY["envs"], leaves_per_pass=STUDY["k"])
            per_run = {k: (cfg.buffer_len + STUDY["steps"]) * v  # warmup, then train steps
                       for k, v in search_launches(cfg.mcts_config()).items()}
            c, _ = run_path("torch_scaling_study train (9x9, 64x2 and 512x4, 4096 envs)",
                            {k: 2 * v for k, v in per_run.items()}, lambda: study.train(sargs))
            slice_launches["study_train"] = c
            new = sorted(set(runs.list_runs()) - before)
            for r in new:
                latest = storage.load_latest(r)
                f0, n0 = latest["n_flops"], latest["n_samples"]
                storage.save_snapshot(r, {"agent": latest["agent"]}, n_samples=n0, n_flops=f0)
                storage.save_snapshot(r, {"agent": latest["agent"]}, n_samples=2 * n0,
                                      n_flops=4 * f0)
            t0 = lap("phase 11b, the study's train stage", t0)
            with Searches() as league:
                c, trials = counted_path("torch_scaling_study evaluate (test_k=8)",
                                         ("walk", "node_actions_multi"),
                                         lambda: study.evaluate(sargs))
            secs = time.time() - t0
            per_search("the study's league", c, league.calls)
            slice_launches["study_league"] = c
            rows = sql.trial_query(9, study.DESC)
            ids = [int(r.id) for r in sql.agent_query() if r.run in new]
            pairs = {(b, w) for b in ids for w in ids if b != w}
            games = float((rows.black_wins + rows.white_wins).sum())
            print(f"the study's league: {len(ids)} agents, {len(rows)} trial rows, {games:.0f} "
                  f"games in {secs:.2f} s: {games / secs:.2f} games/s; card: {card}", flush=True)
            if len(ids) != 4 or set(zip(rows.black_agent.tolist(), rows.white_agent.tolist())) \
                    != pairs or not (rows.black_wins + rows.white_wins > 0).all():
                fail("the study's league: not every ordered pair of its four agents played")
            if study.evaluate(sargs) is not None or len(sql.trial_query(9, study.DESC)) != len(rows):
                fail("the study's league: a rerun added trials")
            ws, gs, order = sql.trial_matrices(rows)
            elo = elos.solve(ws, gs)
            agents = sql.agent_query()
            arrays = argparse.Namespace(
                train_flops=np.array([agents.row(i).train_flops for i in order]),
                boardsize=np.array([agents.row(i).boardsize for i in order], float), elo=elo)
            tf = time.time()
            params = data.fit_model(arrays)
            fit_s = time.time() - tf
            fitted = data.changepoint_apply(params, data.model_inputs(arrays)).numpy()
            rmse = float(np.sqrt(np.mean((fitted - elo) ** 2)))
            print(f"the study's Elos {dict(zip(order, np.round(elo, 4).tolist()))}; "
                  f"data.fit_model on the card: {fit_s:.2f} s, RMSE {rmse:.4f} nats "
                  f"({rmse * data.ELO:.1f} Elo), params "
                  f"{ {k: v.tolist() for k, v in params.items()} }; card: {card}", flush=True)
            if not (np.isfinite(elo).all() and elo.max() == 0 and np.isfinite(rmse)):
                fail("the study's Elos or fit are not finite")

            # c. the top agent's challengers
            t0 = lap("phase 11b, the league, Elos and fit", t0)
            avail = best.std_available(9)
            last_id = int(sql.trial_query(9).index.max())
            with Searches() as calls:
                c, _ = counted_path("best.evaluate(9, n_envs=256, rounds=1)", ("walk",),
                                    lambda: best.evaluate(9, n_envs=256, rounds=1))
            secs = time.time() - t0
            per_search("best.evaluate", c, calls.calls)
            slice_launches["best"] = c
            added = sql.trial_query(9)
            added = added.take(added.index > last_id)
            games = float((added.black_wins + added.white_wins).sum())
            print(f"best.std_available(9): {list(zip(avail.agent.tolist(), np.round(avail.std, 4).tolist()))}; "
                  f"best.evaluate: {len(added)} trial rows, {games:.0f} games in {secs:.2f} s: "
                  f"{games / secs:.2f} games/s; card: {card}", flush=True)
            if len(avail) == 0 or len(added) != 2 or games != 256:
                fail("best: no challenger, or its 256 games were not saved")

            # d. the noise scales of phase 7's latest snapshot
            t0 = lap("phase 11c, best", t0)
            idx = max(storage.snapshots(run))
            timed = {}

            def timing(name, fn):
                def wrapped(*a, **kw):
                    t = time.time()
                    out = fn(*a, **kw)
                    sync()
                    timed[name] = time.time() - t
                    return out
                return wrapped

            collect, gradients = noisescales.collect, noisescales.gradients
            noisescales.collect = timing("collect", collect)
            noisescales.gradients = timing("gradients", gradients)
            try:
                with Searches() as calls:
                    c, aid = counted_path(
                        "noisescales.evaluate (9x9, 1024 envs, 16 steps, perf)", ("walk",),
                        lambda: noisescales.evaluate(run, idx, nodes=64, c_puct=1 / 16, perf=True,
                                                     n_envs=1024, chunk_len=16))
            finally:
                noisescales.collect, noisescales.gradients = collect, gradients
            secs = time.time() - t0
            per_search("noisescales.evaluate", c, calls.calls)
            slice_launches["noise_scales"] = c
            noise = sql.query("select * from noise_scales where agent_id == ?", aid)
            print(f"noise scales of agent {aid} (phase 7's snapshot {idx}): "
                  f"{[(r.kind, r.mean_sq, r.sq_mean, r.variance, r.n_params, r.batch_size, r.batches) for r in noise]}; "
                  f"collection {timed['collect']:.2f} s, per-timestep gradients "
                  f"{timed['gradients']:.3f} s, all with its perf games {secs:.2f} s; card: {card}",
                  flush=True)
            values = np.stack([noise.mean_sq, noise.sq_mean, noise.variance])
            if sorted(noise.kind) != ["joint", "policy", "value"] or not np.isfinite(values).all() \
                    or (noise.n_params != FLAGSHIP_PARAMS).any() or (noise.batches != 16).any():
                fail("noise scales: not three finite rows over 1,176,150 parameters")
            n_trials = len(sql.query("select * from trials"))
            c, _ = run_path("noisescales.evaluate again", {},
                            lambda: noisescales.evaluate(run, idx, nodes=64, c_puct=1 / 16,
                                                         perf=True, n_envs=1024, chunk_len=16))
            if len(sql.query("select * from noise_scales")) != 3 \
                    or len(sql.query("select * from trials")) != n_trials:
                fail("noise scales: a second call added rows")

            # e. perfect play and the MoHex calibration against the stub engine
            t0 = lap("phase 11d, noise scales", t0)
            solver = perfect.Solver(3)
            winners = mohex_calibration.play_out(
                hex.Hex.initial(8, 3, device=DEV),
                [perfect.PerfectAgent(solver), perfect.PerfectAgent(solver, 1)])
            print(f"play_out of PerfectAgent against itself on 3x3: winners {winners.tolist()}",
                  flush=True)
            if (winners != 0).any():
                fail("play_out: black does not win every perfect 3x3 game")
            run3 = [r for r in runs.list_runs() if runs.info(r)["params"].get("boardsize") == 3][-1]
            latest = storage.load_latest(run3)
            storage.save_snapshot(run3, {"agent": latest["agent"]}, n_samples=latest["n_samples"],
                                  n_flops=latest["n_flops"])
            sql.refresh()
            idx3 = max(storage.snapshots(run3))
            aid3 = int(sql.query("select agents.id from agents join snaps on agents.snap == "
                                 "snaps.id where snaps.run == ? and snaps.idx == ?", run3,
                                 idx3).id[0])
            binary = mohex.BINARY
            mohex.BINARY = f"{sys.executable} {os.path.join(os.path.dirname(__file__), 'tests', 'gtp_stub.py')}"
            try:
                c, results = counted_path("mohex_calibration.calibrate (3x3, 16 envs)", ("walk",),
                                          lambda: mohex_calibration.calibrate(aid3, n_envs=16))
            finally:
                mohex.BINARY = binary
            slice_launches["calibrate"] = c
            mrows = sql.mohex_trial_query()
            cal = mohex_calibration.calibrations(3)
            print(f"calibrate against the stub engine: {results}; mohex_trials "
                  f"{[(r.black_agent, r.white_agent, r.black_wins, r.white_wins) for r in mrows]}; "
                  f"calibrations {list(zip(cal.agent_id.tolist(), cal.winrate.tolist(), cal.games.tolist()))}, "
                  f"best agent {mohex_calibration.best_agent(3)}", flush=True)
            if len(mrows) != 2 or cal.agent_id.tolist() != [aid3] or cal.games[0] != 16 \
                    or mohex_calibration.best_agent(3) != aid3:
                fail("calibrate: its mohex_trials rows or calibrations are wrong")
            lap("phase 11e, perfect play and calibrate", t0)
        finally:
            if old_db is None:
                os.environ.pop("BOARDLAW_DB", None)
            else:
                os.environ["BOARDLAW_DB"] = old_db
    torch.cuda.empty_cache()


# phase 11's process: the seconds it may take (about 170 on the card)
RESULTS_DEADLINE_S = 600


def results_database_child(seed, run, out):
    """Phase 11 in a spawned process, in the parent's run root (the
    inherited `BOARDLAW_RUN_ROOT`): the kernels loaded from the parent's
    build, then `check_results_database`; its launches go to the JSON file
    `out`."""
    from boardlaw_tpu_torch.mcts import kernels

    kernels.build()
    launches = {}
    check_results_database(argparse.Namespace(seed=seed), card_line(), run, launches)
    with open(out, "w") as f:
        json.dump(launches, f)


def check_results_database_spawned(args, run, slice_launches):
    """Phase 11 in a process of its own: phase 10d's `torch.profiler` trace
    leaves the card's tracing callbacks on in this process, which slows
    every later launch of the host-bound searches. The child's launches go
    to `slice_launches`; a child that fails or outlives
    `RESULTS_DEADLINE_S` fails the phase."""
    import multiprocessing as mp
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip-smoke-phase11-") as tmp:
        out = os.path.join(tmp, "launches.json")
        child = mp.get_context("spawn").Process(target=results_database_child,
                                                args=(args.seed, run, out))
        child.start()
        child.join(RESULTS_DEADLINE_S)
        if child.is_alive():
            child.terminate()
            child.join(30)
            fail(f"phase 11's process outlived its {RESULTS_DEADLINE_S} s")
        if child.exitcode != 0:
            fail(f"phase 11's process exited with code {child.exitcode}")
        with open(out) as f:
            slice_launches.update(json.load(f))


# --------------------------------------------------------------------------
# Phase 12: the fleet, run backup and the run tools
# --------------------------------------------------------------------------

# phase 12's sweep, `sweep.launch_grid`'s arguments: two jobs of one card
FLEET_GRID = dict(boardsize=9, widths=[64], depths=[1, 2], desc="smoke", n_envs=4096,
                  max_steps=2)
# the seconds both jobs may take, from the first launch to the second's end
# (about 60 on the card)
FLEET_DEADLINE_S = 240


def same_tree(a, b):
    """The paths under `a` and `b` that are not in both or differ in bytes."""
    import filecmp

    cmp = filecmp.dircmp(a, b)
    bad = [os.path.join(a, f) for f in cmp.left_only + cmp.right_only + cmp.funny_files]
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    bad += [os.path.join(a, f) for f in mismatch + errors]
    for sub in cmp.common_dirs:
        bad += same_tree(os.path.join(a, sub), os.path.join(b, sub))
    return bad


# `train.run`'s arguments that are not `make_config`'s
RUN_ONLY = ("desc", "storer", "max_steps", "resume", "arena", "arena_ladder", "n_devices",
            "device")


def fleet_expected(params):
    """A fleet job's kernel launches: its `train.run`'s warmup and steps,
    one search an actor step."""
    from boardlaw_tpu_torch import train

    cfg = train.make_config(**{k: v for k, v in params.items() if k not in RUN_ONLY})
    n_actor = cfg.buffer_len + params["max_steps"]
    return {k: v * n_actor for k, v in search_launches(cfg.mcts_config()).items()}


def job_log_launches(name, log, device_label, expected):
    """A job's `fleet-out.log`: it names the device (for a card, its name
    and UUID, so a job on another card fails), has no traceback, and ends in
    the worker's `kernels.launches` line, whose counts are `expected` (every
    other instantiation 0). Returns the counts."""
    if f"fleet worker: training on {device_label}" not in log or "Traceback" in log:
        fail(f"job {name}'s log does not name {device_label} or has a traceback:\n{log}")
    try:
        counts = search_counts(json.loads(log.strip().splitlines()[-1])["kernels.launches"])
    except (IndexError, ValueError, KeyError):
        fail(f"job {name}'s log does not end in its kernels.launches line:\n{log}")
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want or not (counts["walk"] > 0 and counts["node_actions_multi"] > 0):
        fail(f"job {name} launched {counts}, expected {want}")
    return counts


def check_fleet(card):
    """Phase 12: a sweep of two `train.run` jobs on the card through the fleet
    (`sweep.launch_grid`, `manage.refresh`, a local machine of the one card),
    their runs fetched, backed up and restored, a source snapshot, the
    monitor's tree, the dashboard and its server. The jobs run `python -m
    boardlaw_tpu_torch.fleet.worker`, with `python` this interpreter, from an
    archive of a temporary copy of the package (its `_build/` included) in
    a temporary FLEET_ROOT; each must train on this process's card 0, by
    UUID; every job still running when the phase ends is killed. Returns
    the jobs' kernel launches, summed."""
    import html
    import math
    import re
    import shutil
    import signal
    import tarfile
    import tempfile
    import urllib.request
    from pathlib import Path

    import torch
    from boardlaw_tpu_torch import backup
    from boardlaw_tpu_torch.fleet import jobs, machines, manage, sweep, worker
    from boardlaw_tpu_torch.mcts import kernels
    from boardlaw_tpu_torch.pavlov import archive, dashboard, monitoring, runs, stats, storage
    from boardlaw_tpu_torch.pavlov.tests import mock_dir

    repo = os.path.dirname(os.path.abspath(__file__))
    device_label = worker.device_label(torch.device(DEV, 0) if DEV == "cuda" else DEV)
    saved = {k: os.environ.get(k) for k in ("FLEET_ROOT", "BOARDLAW_RUN_ROOT", "PATH")}
    cwd = os.getcwd()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        tmp = Path(tmp)
        (tmp / "bin").mkdir()
        (tmp / "bin" / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (tmp / "bin" / "python").chmod(0o755)
        os.environ["FLEET_ROOT"] = str(tmp / "fleet")
        os.environ.pop("BOARDLAW_RUN_ROOT", None)  # each job writes in its own directory
        os.environ["PATH"] = f"{tmp / 'bin'}:{saved['PATH']}"
        js = {}
        try:
            t0 = time.time()
            so = Path(kernels.build()._name)  # built before the copy, so the jobs load it
            # `launch_grid` archives the working directory: a copy of the package
            shutil.copytree(os.path.join(repo, "boardlaw_tpu_torch"),
                            tmp / "code" / "boardlaw_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            os.chdir(tmp / "code")
            machines.add("card", "local", resources={"devices": [0]}, workdir=str(tmp / "work"))
            names = sweep.launch_grid(**FLEET_GRID)
            if len(names) != 2 or sweep.launch_grid(**FLEET_GRID) != []:
                fail(f"launch_grid submitted {names}, then more on a second call")
            with tarfile.open(jobs.jobs()[names[0]].archive) as tar:
                carried = f"./boardlaw_tpu_torch/_build/{so.name}" in tar.getnames()
            t0 = lap("phase 12, launch_grid (two archives of the package)", t0)

            launched, ended, first = {}, {}, None
            deadline = time.time() + FLEET_DEADLINE_S
            while True:
                js = manage.refresh()
                now = time.time()
                for n, j in js.items():
                    if j.status != "fresh":
                        launched.setdefault(n, now)
                    if j.status == "dead":
                        ended.setdefault(n, now)
                if first is None:
                    first = sorted(j.status for j in js.values())
                if sum(j.status == "active" for j in js.values()) > 1:
                    fail(f"two jobs active on the one card: {js}")
                if all(j.status == "dead" for j in js.values()):
                    break
                if now > deadline:
                    fail(f"the jobs did not end within {FLEET_DEADLINE_S} s: {js}")
                time.sleep(1.0)
            order = sorted(names, key=launched.get)
            if first != ["active", "fresh"] or launched[order[1]] < ended[order[0]]:
                fail(f"the second job did not wait for the first: first pass {first}, "
                     f"launched {launched}, dead {ended}")
            t0 = lap("phase 12, both jobs to their end", t0)

            tails = manage.tails(n=100_000)
            for n in names:
                counts = job_log_launches(n, tails[n], device_label, fleet_expected(js[n].params))
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                built = tmp / "work" / n / "boardlaw_tpu_torch" / "_build" / so.name
                kept = built.exists() and int(built.stat().st_mtime) == int(so.stat().st_mtime)
                print(f"job {n} ({js[n].params['width']}x{js[n].params['depth']}): the archive "
                      f"carries {so.name}: {carried}; the job's copy unchanged (nvcc did not "
                      f"run): {kept}", flush=True)

            target = tmp / "fetched"
            manage.fetch(str(target))
            store = target / "pavlov"
            with mock_dir(str(store)):
                found = runs.list_runs()
                if len(found) != 2:
                    fail(f"the fetched store holds {found}, not the two jobs' runs")
                steps = FLEET_GRID["max_steps"]
                for run in found:
                    rows = stats.rows(run, "time.step")
                    payload = storage.load_latest(run)
                    if rows is None or len(rows) != steps or payload["agent"]["step"] != steps:
                        fail(f"run {run}: time.step rows {rows}, checkpoint step "
                             f"{payload['agent']['step']}, expected {steps}")
                    name = next(n for n in names
                                if js[n].params["width"] == runs.info(run)["params"]["width"]
                                and js[n].params["depth"] == runs.info(run)["params"]["depth"])
                    b, w, d = (js[name].params[k] for k in ("boardsize", "width", "depth"))
                    print(f"fleet job {name} ({b}x{b}, {w}x{d}, {FLEET_GRID['n_envs']} envs): "
                          f"launch to dead {ended[name] - launched[name]:.2f} s (1 s polls); "
                          f"time.setup.init {stats.rows(run, 'time.setup.init')['x'].tolist()} s; "
                          f"s/step {[round(float(x), 4) for x in rows['total']]}; card: {card}",
                          flush=True)
                backup.backup(tmp / "mirror")
            with mock_dir(str(tmp / "restored")):
                backup.fetch(tmp / "mirror")
                if not all(runs.exists(r) for r in found):
                    fail("the restored store lacks the runs")
            differ = same_tree(str(store), str(tmp / "restored"))
            if differ:
                fail(f"backup and fetch changed {differ}")
            t0 = lap("phase 12, fetch, backup and restore", t0)

            with mock_dir(str(store)):
                run = found[0]
                archive.archive(run, dir=repo)
                path = "boardlaw_tpu_torch/mcts/kernels.py"
                with open(os.path.join(repo, path)) as f:
                    if path not in archive.listing(run) or archive.source(run, path) != f.read():
                        fail(f"the source snapshot lacks {path} or differs from it")

                view = monitoring.tree_view(run)
                groups, head = {}, None
                for line in view.splitlines():
                    if not line.startswith("  "):
                        head = line
                        continue
                    values = [float(tok.rsplit("=", 1)[-1]) for tok in line.split()[1:]]
                    groups.setdefault(head, []).extend(values)
                for head in ("loss", "time"):
                    if not groups.get(head) or not all(map(math.isfinite, groups[head])):
                        fail(f"the monitor's tree has no finite {head} values:\n{view}")

                page = dashboard.render(run)
                charted = {html.unescape(m) for m in re.findall(
                    r'<div class="card"><div class="name" title="([^"]*)">[^<]*</div>'
                    r'<div class="val">[^<]*</div><svg[^>]*>.*?<polyline', page)}
                uncharted = [c for c in stats.channels(run)
                             if c not in charted and not any(x.startswith(f"{c} (") for x in charted)]
                if uncharted:
                    fail(f"the dashboard has no chart of {uncharted}")
                server = dashboard.serve(run)
                try:
                    url = f"http://127.0.0.1:{server.server_address[1]}/"
                    with urllib.request.urlopen(url, timeout=30) as r:
                        status, body = r.status, r.read().decode()
                finally:
                    server.shutdown()
                    server.server_close()
                if status != 200 or body != dashboard.render(run):
                    fail(f"the dashboard's server answered {status} with another page")
                print(f"monitoring and dashboard: {len(stats.channels(run))} channels, "
                      f"{page.count('<polyline')} charts, the page {len(page)} bytes, served "
                      f"with status {status}; pandas "
                      f"{'absent' if 'pandas' not in sys.modules else 'imported, unused'}",
                      flush=True)
            lap("phase 12, archive, monitoring and dashboard", t0)
        finally:
            for j in js.values():
                if j.status == "active":
                    try:
                        os.killpg(j.pid, signal.SIGTERM)
                    except ProcessLookupError:
                        pass
            os.chdir(cwd)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return launches


# the kernels: route, source, the Pallas kernel each replaces (`hex_step`
# and `backup_prefix` replace none: the JAX package steps Hex and backs up a
# K>1 pass in plain XLA)
BASE_KERNELS = {
    "walk": ("cuda", "boardlaw_tpu_torch/csrc/walk.cu", "boardlaw_tpu/mcts/pallas_kernels.py:530"),
    "node_actions_multi": ("cuda", "boardlaw_tpu_torch/csrc/node_actions_multi.cu",
                           "boardlaw_tpu/mcts/pallas_kernels.py:327"),
    "node_actions": ("cuda", "boardlaw_tpu_torch/csrc/node_actions.cu",
                     "boardlaw_tpu/mcts/pallas_kernels.py:207"),
    "descend": ("cuda", "boardlaw_tpu_torch/csrc/descend.cu",
                "boardlaw_tpu/mcts/pallas_kernels.py:642"),
    "backup": ("cuda", "boardlaw_tpu_torch/csrc/backup.cu",
               "boardlaw_tpu/mcts/pallas_kernels.py:797"),
    "backup_dense": ("cuda", "boardlaw_tpu_torch/csrc/backup_dense.cu",
                     "boardlaw_tpu/mcts/pallas_kernels.py:909"),
    "backup_prefix": ("cuda", "boardlaw_tpu_torch/csrc/backup_prefix.cu", None),
    "solve_probs": ("cuda", "boardlaw_tpu_torch/csrc/solve_probs.cu",
                    "boardlaw_tpu/mcts/pallas_kernels.py:75"),
    "sample_children_multi": ("cuda", "boardlaw_tpu_torch/csrc/sample_children_multi.cu",
                              "boardlaw_tpu/mcts/pallas_kernels.py:457"),
    "hex_step": ("cuda", "boardlaw_tpu_torch/csrc/hex_step.cu", None),
}
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=32 * 1024)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--k1-learner-envs", type=int, default=32 * 1024)
    parser.add_argument("--layout-envs", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import tempfile
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.draws import Draws
    from boardlaw_tpu_torch.mcts import kernels
    from boardlaw_tpu_torch.pavlov.tests import mock_dir

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. the kernels
    with Phase("build"):
        kernels.build(verbose=True)

    report = {}
    cfg9 = train.make_config(9, 512, 4, n_envs=args.envs)
    mcfg9 = cfg9.mcts_config()
    cfg9s = scan_config(cfg9)
    model9 = train.build_model(cfg9, device=DEV, generator=torch.Generator().manual_seed(args.seed))
    cfg6 = train.best_config(6, n_envs=args.envs)
    mcfg6 = cfg6.mcts_config()
    model6 = train.build_model(cfg6, device=DEV, generator=torch.Generator().manual_seed(args.seed))

    # 3. the K=8 kernels at the 9x9 path's shapes
    with Phase("K=8 kernels against their twins"):
        draws = Draws(args.seed + 1, DEV)
        tree = mid_search_tree(cfg9, model9, draws, cfg9.n_envs, passes=5)
        ka, kc = check_node_actions_multi(tree, cfg9, draws, report)
        first_tree = mid_search_tree(cfg9, model9, draws, cfg9.n_envs, passes=0)
        check_walk(tree, ka, kc, first_tree, draws, mcfg9, report)
        del tree, ka, kc, first_tree
        check_backup_prefix(cfg9, model9, draws, report, "backup_prefix")
        check_search_cpu_vs_gpu(cfg9, model9)
        torch.cuda.empty_cache()

    # 3b. the split K=8 kernels at the 9x9 scan pass's shapes
    with Phase("split K=8 kernels against their twins"):
        draws = Draws(args.seed + 4, DEV)
        tree = mid_search_tree(cfg9s, model9, draws, cfg9.n_envs, passes=5)
        check_split_kernels(tree, cfg9s, draws, report)
        del tree
        check_search_cpu_vs_gpu(cfg9s, model9)
        torch.cuda.empty_cache()

    # 3c. every lane layout of the row kernels, one small tree per board
    before = read_counts()
    with Phase("row kernels at every board size"):
        check_board_layouts(args.seed + 6, args.layout_envs)
        torch.cuda.empty_cache()

    # 3d. the bf16 instantiations on the bf16 flagship's trees
    with Phase("bf16-logits kernels against their twins"):
        check_bf16_kernels(args.seed + 13, cfg9.n_envs, report)
        torch.cuda.empty_cache()

    # 4. the K=1 kernels at the 6x6 path's shapes
    with Phase("K=1 kernels against their twins"):
        draws = Draws(args.seed + 2, DEV)
        tree = k1_mid_search_tree(cfg6, model6, draws, sims=30)
        B, T = tree.parents.shape
        rands = draws.uniform((B, T))
        acts, nxt = check_node_actions(tree, rands, report)
        leaves = check_descend(tree, rands, acts, nxt, report)
        check_walk_k1(tree, acts, nxt, report, args.seed + 8)
        check_backups(tree, leaves, report, args.seed + 7)
        del tree, acts, nxt, leaves
        check_search_cpu_vs_gpu(cfg6, model6)
        torch.cuda.empty_cache()
    held = held_launches(before)

    # 4b. the Hex step kernel at the paths' shapes
    with Phase("hex_step against its twin"):
        check_hex_step(args.seed + 9, args.envs, report)
        torch.cuda.empty_cache()

    launches = {}
    # 5a. the 9x9 actor path
    with Phase("9x9 actor steps (K=8)"):
        draws = Draws(args.seed, DEV)
        torch.cuda.reset_peak_memory_stats()
        worlds = train.init_worlds(cfg9, draws)
        c, (_, step_s) = run_path(
            f"{args.steps} 9x9 actor steps",
            {k: v * args.steps for k, v in search_launches(mcfg9).items()}
            | {"hex_step": (mcfg9.n_passes + 1) * args.steps},
            lambda: actor_steps(cfg9, model9, worlds, draws, args.steps,
                                2 * mcfg9.leaves_per_pass * mcfg9.n_passes))
        launches.update(walk=c["walk"], node_actions_multi=c["node_actions_multi"],
                        backup_prefix=c["backup_prefix"], hex_step=c["hex_step"])
        sims = cfg9.n_envs * mcfg9.n_passes * mcfg9.leaves_per_pass / steady(step_s)
        f32_figures = {"actor": (steady(step_s), torch.cuda.max_memory_allocated() / 1e9)}
        print(f"actor step (9x9, 512x4, {cfg9.n_envs} envs, 64 nodes, K=8): steps {step_s} s, "
              f"median after the first {steady(step_s):.4f} s/step, {sims:.0f} sims/s, peak "
              f"memory {f32_figures['actor'][1]:.2f} GB; card: {card}", flush=True)
        worlds9 = worlds

    # 5b. the 6x6 K=1 actor path
    with Phase("6x6 actor steps (K=1)"):
        draws = Draws(args.seed, DEV)
        t0 = time.time()
        worlds = worlds6 = train.init_worlds(cfg6, draws)
        sync()
        print(f"mix at 6x6: {time.time() - t0:.2f} s", flush=True)
        sims = mcfg6.n_nodes - 1
        steps6 = max(2, args.steps)
        torch.cuda.reset_peak_memory_stats()
        c, (_, step_s) = run_path(
            f"{steps6} 6x6 K=1 actor steps",
            {"node_actions": steps6 * sims, "walk": steps6 * sims, "backup": steps6 * sims,
             "hex_step": steps6 * (sims + 1)},
            lambda: actor_steps(cfg6, model6, worlds, draws, steps6, 2 * sims))
        launches.update(node_actions=c["node_actions"], backup=c["backup"], **held)
        report["walk"]["k1"]["launches"] = c["walk"]
        f32_figures["k1 actor"] = (steady(step_s), torch.cuda.max_memory_allocated() / 1e9)
        print(f"K=1 actor step (6x6, 128x1, {cfg6.n_envs} envs, 64 nodes): steps {step_s} s, "
              f"median after the first {steady(step_s):.4f} s/step, "
              f"{cfg6.n_envs * sims / steady(step_s):.0f} sims/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}", flush=True)

        del worlds
        torch.cuda.empty_cache()

    # 5d. the 9x9 learner; its first two steps are phase 10a's reference,
    # its state phase 10d's
    with Phase("9x9 learner"):
        single = {"steps": 2}
        _, *f32_figures["learner"] = check_learner(cfg9, args.seed, max(args.steps, 2),
                                                   "the 9x9 learner (K=8)", keep=single)
        torch.cuda.empty_cache()

    # 5e. the 6x6 K=1 learner; its warmup cut to 16 actor steps (a
    # 16-step buffer), the depth that keeps the script inside its time
    with Phase("6x6 K=1 learner"):
        check_learner(train.best_config(6, n_envs=args.k1_learner_envs, buffer_len=16),
                      args.seed, 1, "the 6x6 learner (K=1, a 16-step buffer)")
        torch.cuda.empty_cache()

    # 5f. a tiny train step on the card against the CPU
    with Phase("train step, card vs CPU"):
        check_train_step_cpu_vs_gpu(args.seed)
        check_train_step_cpu_vs_gpu(args.seed, "bfloat16", rtol=BF16_STEP_RTOL)

    # 5g. the 9x9 scan path, from 5a's worlds
    with Phase("9x9 scan path (K=8, split kernels)"):
        mcfg9s = cfg9s.mcts_config()
        draws = Draws(args.seed, DEV)
        torch.cuda.reset_peak_memory_stats()
        c, (_, step_s) = run_path(
            f"{args.steps} 9x9 scan actor steps",
            {k: v * args.steps for k, v in search_launches(mcfg9s).items()},
            lambda: actor_steps(cfg9s, model9, worlds9, draws, args.steps,
                                2 * mcfg9s.leaves_per_pass * mcfg9s.n_passes))
        launches.update(solve_probs=c["solve_probs"],
                        sample_children_multi=c["sample_children_multi"])
        sims = cfg9s.n_envs * mcfg9s.n_passes * mcfg9s.leaves_per_pass / steady(step_s)
        f32_figures["scan actor"] = (steady(step_s), torch.cuda.max_memory_allocated() / 1e9)
        print(f"scan actor step (9x9, 512x4, {cfg9s.n_envs} envs, 64 nodes, K=8, solve_probs + "
              f"sample_children_multi): steps {step_s} s, median after the first "
              f"{steady(step_s):.4f} s/step, {sims:.0f} sims/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}", flush=True)
        check_learner(cfg9s, args.seed, 1, "the 9x9 scan learner (K=8, split kernels)",
                      worlds=worlds9)
        torch.cuda.empty_cache()

    # 5h. the other scan routes
    with Phase("9x9 scan routes"):
        check_scan_routes(cfg9s, model9, worlds9, args.seed + 5)
        torch.cuda.empty_cache()

    # 5i. the bf16 flagship: bf16 network and tree logits, from 5a's worlds
    with Phase("9x9 bf16 flagship path"):
        launches.update(check_bf16_paths(args, worlds9, worlds6, f32_figures, card))
        del worlds9, worlds6
        torch.cuda.empty_cache()

    slice_launches = {}
    # 6a. the planted-value games by every search route
    with Phase("planted-value searches"):
        slice_launches["planted"] = check_validation_searches(args.seed + 9, args.envs)
        torch.cuda.empty_cache()

    # 6b. the planted 3x3 Hex game
    with Phase("planted 3x3 Hex game"):
        slice_launches["planted_hex"] = check_planted_hex(args.seed + 10, args.envs)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-runs-") as root, mock_dir(root):
        # 7. the training entry point: a run, and its resume
        with Phase("train.run and resume"):
            slice_launches["run"], run = check_train_run(args, card, f32_figures["learner"][0])
            torch.cuda.empty_cache()

        # 8. the wide tree at full width
        with Phase("the wide tree (n_nodes > 127)"):
            wide, wide_held = check_wide_tree(args, card, report)
            launches.update({k: v for k, v in (wide | wide_held).items() if k not in launches})
            slice_launches["wide"] = wide
            torch.cuda.empty_cache()

        # 9. evaluation on the card, on phase 7's run
        eval_figures = {}
        with Phase("evaluation"):
            slice_launches["eval"] = check_evaluation(args, card, run, eval_figures)
            torch.cuda.empty_cache()

        # 10. data parallelism, the process pools and utils/ on the card
        with Phase("two ranks on the card (data parallel)"):
            slice_launches["data_parallel"] = check_data_parallel(args, card, cfg9, single)
        with Phase("train.run(n_devices=2) on one card"):
            check_run_refuses()
        with Phase("evaluate_parallel on the card"):
            check_evaluate_parallel(args, card, run, eval_figures["league"])
        with Phase("utils on the card"):
            check_utils_on_card(cfg9, single, card)
            del single
            torch.cuda.empty_cache()

        # 11. the results database and the scaling study, on phase 7's run
        with Phase("the results database and the scaling study"):
            check_results_database_spawned(args, run, slice_launches)

    # 12. the fleet, run backup and the run tools
    with Phase("the fleet, backup and the run tools"):
        slice_launches["fleet"] = check_fleet(card)

    unlaunched = [k for k in kernels.launches if not launches.get(k)]
    if unlaunched:
        fail(f"no path launched {unlaunched}")

    # 13. the records
    def figures(r):
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / F32_FLOPS * 1e3
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    rows = []
    # every instantiation an entry of its own, as `kernels.instance` names
    # them: the bf16 logits' (`.bf16`, csrc/row_solve.cuh `load_logit`), the
    # wide tree's int32 children with bf16 counts (`.mixed`, T = 128) and
    # with f32 counts (`.wide`)
    for name in kernels.launches:
        route, source, replaces = BASE_KERNELS[name.split(".")[0]]
        r = report[name]
        row = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": launches[name], **figures(r), "library_ms": None,
               "slice_launches": {path: c.get(name, 0) for path, c in slice_launches.items()}}
        if name == "walk":  # the other shapes it runs at: the first grow pass, K=1, wide
            for shape in ("first_grow_pass", "k1", "k1_chain", "k1_T256", "k1_T128",
                          "grow_T513"):
                row[shape] = {**figures(r[shape]), "shape": r[shape]["shape"],
                              "designs": r[shape]["designs"]}
            row["k1"]["launches"] = r["k1"]["launches"]
            row["designs"] = r["designs"]
        if name == "hex_step":  # the 6x6 K=1 sim's call
            row["6x6"] = {**figures(r["6x6"]), "shape": r["6x6"]["shape"]}
        rows.append(row)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
