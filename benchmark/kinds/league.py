"""A league, the evaluation that rates snapshots: `arena.neural`'s
`ChunkEvaluator` over one shared env array, `.step()` back to back, one
agent acting a ply on the envs whose seat it holds. The agents are
`MCTSAgent`s over networks made from seed, seed+1, ..., acting on their
root policy's argmax; every ordered pair is a matchup, with more games to
play than any window finishes, so finished envs are refilled.

A sample of `check_plies` of the window's plies, drawn from the seed as
they come, is kept (references, no copies): the worlds before and after,
the acting agent, the tracker's assignment, the draws' position, the root
policies, the actions and the finished games. After the window the
reference checks them: the search's root policies and actions again from
the ply's worlds and draws, and the env step, the acting envs and the
finished games from the program's actions.
"""
from __future__ import annotations

import random
import statistics
import time
from collections import Counter

import numpy as np
import torch

from .. import check, weights
from ..draws import KeyedDraws
from ..reference import hex as ref_hex, learner, mcts
from .selfplay import answer_altered, note, peak, precision, program_config


def _names(traffic):
    return [f"agent{i}" for i in range(traffic["n_agents"])]


def _search(cell):
    """The agents' search settings: the configuration's, with the
    traffic's `search` over them."""
    cfg = cell.config
    out = {"n_nodes": cfg["n_nodes"], "c_puct": cfg["c_puct"], "noise_eps": cfg["noise_eps"]}
    out.update(cell.traffic["search"])
    return out


class Plies:
    """A uniform sample of `k` of the plies played since `restart`, drawn
    from the seed as they come (a reservoir), so a window of any length
    keeps k plies and no more."""

    def __init__(self, k, seed):
        self.k, self.seed = k, seed
        self.restart()

    def restart(self):
        self.rng, self.n, self.kept, self.current = random.Random(self.seed), 0, [], None

    def add(self, ply):
        self.n += 1
        if len(self.kept) < self.k:
            self.kept.append(ply)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.kept[j] = ply


class Recorder:
    """Wraps an agent: each call keeps its world, its draws' position, the
    tracker's assignment and the agent's decisions as the current ply."""

    def __init__(self, name, agent, ev, plies):
        self.name, self.agent, self.ev, self.plies = name, agent, ev, plies

    def __call__(self, world, draws=None, eval=False):
        ply = {"name": self.name, "board": world.board, "seats": world.seats, "n": draws.n,
               "live": self.ev.tracker.live.copy()}
        decisions = self.agent(world, draws, eval=eval)
        ply.update(logits=decisions["logits"], actions=decisions["actions"])
        self.plies.current = ply
        return decisions


def set_up(cell, seed, device):
    from boardlaw_tpu_torch import train
    from boardlaw_tpu_torch.arena import neural
    from boardlaw_tpu_torch.mcts import kernels
    from boardlaw_tpu_torch.mcts.search import MCTSAgent
    from boardlaw_tpu_torch.models.networks import make_eval_fn

    cfg, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        kernels.build()
    tcfg = program_config(cfg)
    names = _names(traffic)
    plies = Plies(traffic["check_plies"], seed)
    agents = {}
    for i, name in enumerate(names):
        model = train.build_model(tcfg, device=device)
        model.load_state_dict(weights.make(cfg, seed + i, device))
        agents[name] = MCTSAgent(make_eval_fn(model), **_search(cell))
    ev = neural.ChunkEvaluator(cfg["boardsize"], traffic["n_envs"], agents,
                               neural.all_matchups(names), traffic["n_envs_per"], seed, device)
    ev.draws = KeyedDraws(seed, device)
    ev.agents = {name: Recorder(name, a, ev, plies) for name, a in agents.items()}
    for _ in range(traffic["warm_plies"]):
        play_ply(ev, plies)
    plies.restart()
    return ev, plies


def play_ply(ev, plies):
    """One `ChunkEvaluator.step`; the ply its agent recorded gets the worlds
    after the step and the games it finished, and goes to the sample."""
    results = ev.step()
    ply, plies.current = plies.current, None
    if ply is not None:
        ply.update(after_board=ev.world.board, after_seats=ev.world.seats, results=results)
        plies.add(ply)


def run(cell, seed, seconds, trace_path, device, t0):
    ev, plies = set_up(cell, seed, device)
    out = {"end_to_end": {"setup_s": time.perf_counter() - t0}}
    if trace_path is None:
        moves0, start = ev.moves, time.perf_counter()
        while True:
            play_ply(ev, plies)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        out["end_to_end"]["league_moves_per_s"] = (ev.moves - moves0) / elapsed
    else:
        from .. import trace

        n, k = cell.traffic["timed_plies"], cell.traffic["profiled_plies"]
        start = time.perf_counter()
        for _ in range(n):
            play_ply(ev, plies)
        step_s = time.perf_counter() - start
        with trace.profiled(trace_path) as got:
            for _ in range(k):
                play_ply(ev, plies)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        out["ctx"] = {"cell": cell, "timed": n, "step_s": step_s, "profiled": k,
                      "trace": got["trace"]}
    out["attempted"] = plies.n
    out["memory_peak_bytes"] = peak(device)
    matchups = ev.tracker.matchups
    del ev
    clock = time.perf_counter()
    out["numbers"] = compare(cell, seed, device, plies.kept, matchups)
    note("the reference and the comparison", clock)
    return out


def expected_mask(ply, matchups):
    """The acting agent and its envs by the tracker's rule: the name that
    holds the seat to move in the most live envs (the first such name in
    env order on a tie) and the envs where it does."""
    seats = ply["seats"].cpu().numpy()
    owner = [matchups[i][seats[e]] if i >= 0 else None for e, i in enumerate(ply["live"])]
    counts = {}
    for o in owner:
        if o is not None:
            counts[o] = counts.get(o, 0) + 1
    name = max(counts, key=counts.get)
    return name, np.array([o == name for o in owner])


def reference_ply(cell, seed, device, ply, matchups, prec="float32", fault=None):
    """The reference's root policy and actions for the ply's agent, and the
    envs and games it expects from the program's actions."""
    cfg, search = cell.config, _search(cell)
    name, mask = expected_mask(ply, matchups)
    params = weights.make(cfg, seed + _names(cell.traffic).index(name), device)
    draws = KeyedDraws(seed, device, ply["n"])
    logits, _, _, _ = mcts.search(ply["board"], ply["seats"],
                                  learner.evaluator(params, cfg, prec), draws,
                                  search["n_nodes"], search.get("leaves_per_pass", 1),
                                  search["c_puct"], search["noise_eps"])
    if fault == "answer":
        logits = logits.roll(1, -1)
    return {"name": name, "mask": mask, "logits": logits, "actions": torch.argmax(logits, -1)}


def env_mismatch(ply, mask, matchups):
    """Envs whose world after the ply is not the Hex step of the program's
    actions where the agent acts (and unchanged elsewhere), plus finished
    games that differ from those the step ends."""
    m = torch.as_tensor(mask, device=ply["board"].device)
    board, seats, terminal, rewards = ref_hex.step(ply["board"], ply["seats"], ply["actions"])
    board = torch.where(m[:, None, None], board, ply["board"])
    seats = torch.where(m, seats, ply["seats"])
    bad = int(((board != ply["after_board"]).flatten(1).any(1) | (seats != ply["after_seats"]))
              .sum())
    ended = np.flatnonzero(terminal.cpu().numpy() & mask)
    wins = rewards.cpu().numpy() == 1
    want = Counter((matchups[ply["live"][e]], float(wins[e, 0]), float(wins[e, 1]))
                   for e in ended)
    got = Counter(ply["results"])
    return bad + sum(((want - got) + (got - want)).values())


def compare(cell, seed, device, plies, matchups, prec=None, fault=None, against=None):
    """The numbers `correct` is decided on, over the chosen plies: root
    policies, actions and the env. With `against`, the reference at
    `prec`/`fault` stands in for the program and is held to `against`'s
    (the sound reference's) root policies and actions.

    `policy` and `actions` are the worst ply's gaps; `policy_median` and
    `actions_median` the median ply's, which a cell's limits take where one
    sound ply in a few can part whole: the search's q-bounds are the
    min and max over every env's tree, so where a rounding split in the one
    env that holds a bound moves it, every env's search moves with it, on
    both sides alike, and that ply reads as far apart as the control."""
    prec = prec or precision(cell.config)
    policy, actions, env = [], [], 0.0
    for j, ply in enumerate(plies):
        ref = reference_ply(cell, seed, device, ply, matchups, prec, fault)
        mine = {"logits": ply["logits"], "actions": ply["actions"]} if against is None else ref
        base = ref if against is None else against[j]
        m = torch.as_tensor(base["mask"], device=mine["actions"].device)
        policy.append(check.policy_gap(mine["logits"], base["logits"]))
        actions.append(float(((mine["actions"].long() != base["actions"].long()) & m).float().sum()
                             / m.float().sum().clamp_min(1)))
        if against is None:
            env += env_mismatch(ply, ref["mask"], matchups)
    return {"policy": max(policy), "actions": max(actions), "env": env,
            "policy_median": statistics.median(policy), "actions_median": statistics.median(actions)}


def control(cell, seed, device, seconds):
    """The readings limits are set from (`control.py`): the program's plies
    of a `seconds` window against the reference at the configuration's
    precision, and the control (the reference one precision lower) and the
    "answer" fault against the sound reference."""
    from ..control import control_precision

    ev, plies = set_up(cell, seed, device)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        play_ply(ev, plies)
    matchups = ev.tracker.matchups
    del ev
    chosen = plies.kept
    prec = precision(cell.config)
    sound = [reference_ply(cell, seed, device, p, matchups, prec) for p in chosen]
    out = {"program": compare(cell, seed, device, chosen, matchups)}
    out["control"] = compare(cell, seed, device, chosen, matchups,
                             prec=control_precision(device, cell.config), against=sound)
    out["answer"] = compare(cell, seed, device, chosen, matchups, fault="answer", against=sound)
    return out


def tiny(cell):
    """The loop at a size a CPU test holds: 16 envs, a few plies, the
    search's K as the configuration's and a wide search (over 127 nodes)
    kept wide, at 129 nodes, so that the tree keeps its storage types."""
    search = dict(cell.traffic["search"], leaves_per_pass=cell.config["leaves_per_pass"])
    if "n_nodes" in search:
        search["n_nodes"] = min(search["n_nodes"], 129)
    cell.traffic.update(n_envs=16, check_plies=3, timed_plies=2, profiled_plies=3, search=search)


def fewer_envs(cell):
    """The cell at its widths and search on fewer envs and plies, for the
    control's test on the card."""
    cell.traffic.update(n_envs=256, check_plies=3)


def half_the_envs(monkeypatch):
    """A fault planted in the program: the tracker hands the acting agent
    half of its envs."""
    from boardlaw_tpu_torch.arena import neural

    suggest = neural.Tracker.suggest

    def half(self, seats):
        name, mask = suggest(self, seats)
        mask[len(mask) // 2:] = False
        return name, mask

    monkeypatch.setattr(neural.Tracker, "suggest", half)


FAULTS = {f.__name__: f for f in (answer_altered, half_the_envs)}
