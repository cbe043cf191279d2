"""Self-play training, the loop `train.run` drives: set-up is `init` (the
mix) and `warmup` (the buffer filled), then `train_step` back to back,
its aux brought to the host once a step in one transfer, as `run`'s loop
does.

The first `check_steps` steps run in set-up through the same call, and
what they produce is what the reference is held to: the first step's loss
terms, root policies and Hex step, the first gradient (read from Adam's
first moment after one step), the weights' change after the last and,
for a network with buffers, the buffers after the last. The
reference follows those steps from the program's state at the first of
them (its worlds and buffer), so the start and the stage before it are
checked by themselves: the mix replayed on a sample of envs, and one
warmup step, drawn from the seed, recomputed from the worlds it stored.
"""
from __future__ import annotations

import random
import sys
import time
from dataclasses import fields

import numpy as np
import torch

from .. import check, weights, work
from ..draws import KeyedDraws
from ..reference import hex as ref_hex, learner, nets

BUFFER = ("logits", "prior", "v", "n_leaves", "terminal", "rewards")
BETA1 = 0.9


def program_config(cfg):
    from boardlaw_tpu_torch import train

    names = {f.name for f in fields(train.TrainConfig)}
    return train.TrainConfig(**{k: v for k, v in cfg.items() if k in names})


def precision(cfg):
    return "bfloat16" if cfg["dtype"] == "bfloat16" else "float32"


def note(what, since):
    """A phase's time on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"{what}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device):
    """The process's peak of device memory so far (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _host(x):
    """A copy on the host (`.cpu()` of a CPU tensor is the tensor itself)."""
    return x.detach().to("cpu", copy=True)


def _cpu_world(world):
    return {"board": _host(world.board), "seats": _host(world.seats)}


def _snapshot(state):
    buf = state.buffer
    out = {"ptr": state.ptr, "buffer": {k: _host(buf[k]) for k in BUFFER}}
    out["buffer"].update(_cpu_world(buf["worlds"]))
    out.update(_cpu_world(state.worlds))
    return out


def _entry(board, seats, slot_of, slot):
    """One actor step's outputs: the record of `slot` in a buffer-like dict
    and the worlds it led to."""
    out = {k: _host(slot_of[k][slot]) for k in ("logits", "terminal", "rewards")}
    out.update(board=_host(board), seats=_host(seats))
    return out


def set_up(cell, seed, device):
    """Set-up of a run: the program's train state after the mix, the warmup
    and the checked steps, its draws and step, and what the checked steps
    produced (`rec`)."""
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.mcts import kernels

    cfg, traffic = cell.config, cell.traffic
    clock = time.perf_counter()
    if device.type == "cuda":
        kernels.build()
    model, _, init, warmup, step = train.make_train(program_config(cfg), device=device)
    w0 = weights.make(cfg, seed, device)
    model.load_state_dict(w0)
    draws = KeyedDraws(seed, device)
    clock = note("set-up: kernels and weights", clock)
    state = init(draws)
    c_warm = draws.n
    _sync(device)
    clock = note("set-up: init (the mix)", clock)
    state = warmup(state, draws)
    _sync(device)
    clock = note("set-up: warmup", clock)
    rec = {"c_warm": c_warm, "c_step": draws.n, "snapshot": _snapshot(state), "steps": []}
    T = cfg["buffer_len"]
    for i in range(traffic["check_steps"]):
        state, aux = step(state, draws)
        host = train._host_scalars(aux)
        entry = _entry(state.worlds.board, state.worlds.seats, state.buffer, (state.ptr - 1) % T)
        entry["loss"] = [host["loss.total"], host["loss.policy"], host["loss.value"]]
        rec["steps"].append(entry)
        if i == 0:
            # an optimizer that kept no moment got no gradient
            moments = state.optimizer.state
            rec["grad"] = {n: _host(moments.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                           / (1 - BETA1) for n, p in state.model.named_parameters()}
    rec["change"] = {n: _host(p - w0[n]) for n, p in state.model.named_parameters()}
    rec["buffers"] = {n: _host(b) for n, b in state.model.named_buffers()}
    _sync(device)
    note("set-up: the state to the host and the checked steps", clock)
    return state, draws, step, rec


def program_outputs(cell, seed, rec):
    """The program's side of the comparison: the checked steps, the
    warmup step drawn from the seed and the mixed worlds of the sample."""
    snap, T = rec["snapshot"], cell.config["buffer_len"]
    t, sample = _drawn(cell, seed, snap["board"].shape[0])
    buf = snap["buffer"]
    if t + 1 < T:
        nxt = buf["board"][t + 1], buf["seats"][t + 1]
    else:
        nxt = snap["board"], snap["seats"]
    return {"steps": rec["steps"], "grad": rec["grad"], "change": rec["change"],
            "buffers": rec["buffers"], "warm": _entry(*nxt, buf, t),
            "mix": {"board": buf["board"][0][sample], "seats": buf["seats"][0][sample]}}


def _drawn(cell, seed, B):
    """The warmup slot and the envs of the mix sample a seed checks."""
    rng = random.Random(seed)
    t = rng.randrange(cell.config["buffer_len"])
    return t, torch.tensor(sorted(rng.sample(range(B), min(B, cell.traffic["mix_sample"]))))


def reference_outputs(cell, seed, device, rec, prec="float32", fault=None):
    """What the reference works out from the same weights, draws and the
    program's state before the checked steps, in `program_outputs`' form."""
    cfg = cell.config
    snap, T = rec["snapshot"], cfg["buffer_len"]
    w0 = weights.make(cfg, seed, device)
    buf = {k: x.to(device, copy=True) for k, x in snap["buffer"].items()}
    B, A = snap["board"].shape[0], cfg["boardsize"] ** 2
    t, sample = _drawn(cell, seed, B)

    # the start: the mix replayed on the sample, on the host
    clock = time.perf_counter()
    draws = KeyedDraws(seed, device)
    idx = sample.to(device)
    gumbels = torch.stack([draws.gumbel((B, A))[idx] for _ in range(cfg["mix_steps"])])
    gumbels = gumbels.cpu().numpy()
    board = np.zeros((len(sample),) + tuple(snap["board"].shape[1:]), dtype=np.uint8)
    seats = np.zeros(len(sample), dtype=snap["seats"].numpy().dtype)
    for g in gumbels:
        empty = board == ref_hex.EMPTY
        valid = np.where((seats == 1)[:, None, None], empty.transpose(0, 2, 1), empty)
        logits = np.where(valid.reshape(len(sample), -1), 0.0, -np.inf) + g
        if fault == "answer":
            logits = np.roll(logits, 1, -1)
        board, seats, _, _ = ref_hex.step_host(board, seats, np.argmax(logits, -1))
    out = {"mix": {"board": torch.from_numpy(board), "seats": torch.from_numpy(seats)}}
    clock = note("reference: the mix", clock)

    # the warmup step of slot t, from the worlds it stored
    per = (rec["c_step"] - rec["c_warm"]) // T
    draws = KeyedDraws(seed, device, rec["c_warm"] + t * per)
    nb, ns, record, _ = learner.actor(cfg, w0, buf["board"][t], buf["seats"][t], draws, prec, fault)
    out["warm"] = _entry(nb, ns, record, slice(None))
    clock = note("reference: a warmup step", clock)

    # the checked steps, from the program's state before them
    layout = nets.module(cfg).layout(cfg)
    trained = nets.trainable(layout)
    st = {"board": snap["board"].to(device), "seats": snap["seats"].to(device), "buffer": buf,
          "ptr": snap["ptr"], "params": dict(w0), "t": 0,
          "m": {k: torch.zeros_like(w0[k]) for k in trained},
          "v": {k: torch.zeros_like(w0[k]) for k in trained}}
    draws = KeyedDraws(seed, device, rec["c_step"])
    out["steps"] = []
    for i in range(len(rec["steps"])):
        o = learner.train_step(cfg, st, draws, prec, fault)
        entry = _entry(o["board"], o["seats"], o["record"], slice(None))
        entry["loss"] = o["loss"]
        out["steps"].append(entry)
        if i == 0:
            out["grad"] = {k: g.cpu() for k, g in o["grad"].items()}
    out["change"] = {k: (st["params"][k] - w0[k]).cpu() for k in trained}
    out["buffers"] = {k: st["params"][k].cpu() for k in nets.buffers(layout)}
    note("reference: the checked steps", clock)
    return out


def compare(prog, ref):
    """The numbers `correct` is decided on. The searches after the first
    update run on weights that the two sides' Adam rounded apart, and a
    draw that flips there spreads to thousands of envs; so the root
    policies, the Hex steps and the loss terms are held at the warmup step
    and the first checked step, and the later steps reach the comparison
    through the weights' change. A network with buffers adds `buffers`,
    their worst leaf after the checked steps."""
    acts = [(prog["warm"], ref["warm"]), (prog["steps"][0], ref["steps"][0])]
    world = ("board", "seats", "terminal", "rewards")
    out = {
        "loss": max(check.rel_gap(a, b) for a, b in zip(prog["steps"][0]["loss"],
                                                         ref["steps"][0]["loss"])),
        "grad": check.leaf_gap(prog["grad"], ref["grad"]),
        "change": check.leaf_gap(prog["change"], ref["change"], check.moved(ref["grad"])),
        "policy": max(check.policy_gap(p["logits"], r["logits"]) for p, r in acts),
        "boards": max(check.share_differing(*((p[k], r[k]) for k in world)) for p, r in acts),
        "mix": float((check.share_differing((prog["mix"]["board"], ref["mix"]["board"]),
                                            (prog["mix"]["seats"], ref["mix"]["seats"]))
                      * len(ref["mix"]["seats"]))),
    }
    if ref["buffers"]:
        out["buffers"] = check.leaf_gap(prog["buffers"], ref["buffers"])
    return out


def run(cell, seed, seconds, trace_path, device, t0):
    """One run. -> dict: end_to_end, ctx (traced runs), attempted,
    memory_peak_bytes, numbers."""
    from boardlaw_tpu_torch import train

    state, draws, step, rec = set_up(cell, seed, device)
    out = {"end_to_end": {"setup_s": time.perf_counter() - t0}}
    B = cell.config["n_envs"]
    if trace_path is None:
        start, n = time.perf_counter(), 0
        while True:
            state, aux = step(state, draws)
            train._host_scalars(aux)
            n += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        out["end_to_end"]["train_samples_per_s"] = n * B / elapsed
        out["attempted"] = n
    else:
        state, out["ctx"] = traced(cell, state, draws, step, trace_path, device)
        out["attempted"] = out["ctx"]["timed"] * 2 + out["ctx"]["profiled"]
    out["memory_peak_bytes"] = peak(device)
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    clock = time.perf_counter()
    prog = program_outputs(cell, seed, rec)
    ref = reference_outputs(cell, seed, device, rec, precision(cell.config))
    out["numbers"] = compare(prog, ref)
    note("the reference and the comparison", clock)
    return out


def traced(cell, state, draws, step, path, device):
    """The per-layer readings: `timed_steps` steps on the host clock, the
    same again with the actor timed apart (a synchronize at each end), then
    `profiled_steps` under the profiler."""
    from boardlaw_tpu_torch import train
    from .. import trace

    n, k = cell.traffic["timed_steps"], cell.traffic["profiled_steps"]

    def steps(count):
        nonlocal state
        _sync(device)
        start = time.perf_counter()
        for _ in range(count):
            state, aux = step(state, draws)
            train._host_scalars(aux)
        _sync(device)
        return time.perf_counter() - start

    step_s = steps(n)
    actor_s = 0.0
    actor = train.actor_record

    def timed_actor(*args, **kwargs):
        nonlocal actor_s
        _sync(device)
        start = time.perf_counter()
        result = actor(*args, **kwargs)
        _sync(device)
        actor_s += time.perf_counter() - start
        return result

    train.actor_record = timed_actor
    try:
        wrapped_s = steps(n)
    finally:
        train.actor_record = actor
    with trace.profiled(path) as got:
        steps(k)
    ctx = {"cell": cell, "timed": n, "profiled": k, "step_s": step_s, "wrapped_s": wrapped_s,
           "actor_s": actor_s, "trace": got["trace"], "work": work, "n_envs": cell.config["n_envs"],
           "precision": precision(cell.config)}
    return state, ctx


def control(cell, seed, device, seconds=None):
    """The readings limits are set from (`control.py`): the program against
    the reference at the configuration's precision, the control (the
    reference one precision lower) and the reference's faults ("answer",
    "half") against the same."""
    from ..control import control_precision

    state, _, _, rec = set_up(cell, seed, device)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prec = precision(cell.config)
    ref = reference_outputs(cell, seed, device, rec, prec)
    out = {"program": compare(program_outputs(cell, seed, rec), ref)}
    out["control"] = compare(reference_outputs(
        cell, seed, device, rec, control_precision(device, cell.config)), ref)
    for fault in ("answer", "half"):
        out[fault] = compare(reference_outputs(cell, seed, device, rec, prec, fault), ref)
    return out


def tiny(cell):
    """The loop at a size a CPU test holds: a few envs, a short buffer and
    mix, a few steps."""
    cell.config.update(n_envs=32, buffer_len=4, mix_steps=20)
    cell.traffic.update(mix_sample=8, timed_steps=2, profiled_steps=1)


def fewer_envs(cell):
    """The cell at its widths, nodes and buffer on fewer envs and a short
    mix, for the control's test on the card. The buffer stays the cell's:
    its length sets the share of the newest step in the learner's batch,
    and so how far a search that the two sides' rounding split apart moves
    the weights' change."""
    cell.config.update(n_envs=2048, mix_steps=20)
    cell.traffic.update(mix_sample=8)


# Faults planted in the program, under its kernels' wrappers, for the test
# that a run with its timed path broken is not correct; each takes pytest's
# `monkeypatch`.

class _Still(torch.optim.Adam):
    """An optimizer whose step leaves the weights and its state as they are."""

    def step(self, closure=None):
        return None


def unchanged(monkeypatch):
    from boardlaw_tpu_torch import train

    monkeypatch.setattr(train, "make_optimizer", lambda cfg, params: _Still(params, lr=cfg.lr))


def half_batch(monkeypatch):
    from dataclasses import replace

    from boardlaw_tpu_torch import train

    losses = train.losses

    def half(model, batch):
        n = batch["logits"].shape[0] // 2
        cut = {k: v[:n] for k, v in batch.items() if k != "worlds"}
        cut["worlds"] = replace(batch["worlds"], board=batch["worlds"].board[:n],
                                seats=batch["worlds"].seats[:n])
        return losses(model, cut)

    monkeypatch.setattr(train, "losses", half)


def answer_altered(monkeypatch):
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.mcts import search

    root = search.root

    def rolled(tree):
        r = root(tree)
        return dict(r, logits=r["logits"].roll(1, -1))

    monkeypatch.setattr(train, "mcts_root", rolled)
    monkeypatch.setattr(search, "root", rolled)


def mix_cut_short(monkeypatch):
    from boardlaw_tpu_torch import learning

    mix = learning.mix
    monkeypatch.setattr(learning, "mix", lambda world, draws, T=2500: mix(world, draws, T - 1))


FAULTS = {f.__name__: f for f in (unchanged, half_batch, answer_altered, mix_cut_short)}
