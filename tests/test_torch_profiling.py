"""The port's spans and counters (`utils/profiling.py`): nothing recorded
and no profiler event while tracing is off; nesting, parent ids, inherited
ids and a bounded store while it is on; a train step (K=4 grow passes and
K=1) and a league ply bit-equal with tracing on and off, with exactly the
span tree the hot paths name; `sync.hex.flood` against the `bool()` calls
of a flood of known length; and, on a card, every `sync.*` counter against
the waits `torch.cuda.set_sync_debug_mode` reports."""
import json
import math
import sys
import threading
import warnings

import pytest
import torch

from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.arena import neural
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts.search import MCTSAgent
from boardlaw_tpu_torch.models.networks import make_eval_fn
from boardlaw_tpu_torch.utils import profiling

torch.set_num_threads(2)

SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def tracing():
    """Tracing on, over an empty store; off and empty again after."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(autouse=True)
def _off_after():
    yield
    profiling.enable(False)
    profiling.reset()


def annotations(prof):
    events = json.loads(prof.path.read_text())["traceEvents"]
    return {e.get("name") for e in events if e.get("cat") == "user_annotation"}


def tree(records):
    """The spans as nested (name, children) tuples in the order they
    opened, from the top spans down."""
    kids = {}
    for r in sorted(records, key=lambda r: (r[1], r[3])):
        kids.setdefault(r[4], []).append(r)
    ids = {r[3] for r in records}

    def build(r):
        return (r[0], [build(c) for c in kids.get(r[3], [])])

    return [build(r) for r in sorted(records, key=lambda r: r[1]) if r[4] not in ids]


def test_span_and_count_off_record_nothing(tmp_path):
    profiling.enable(False)
    profiling.reset()
    assert profiling.span("t.a") is profiling.span("t.a", step=1)  # the shared null
    with profiling.trace(tmp_path) as prof:
        with profiling.span("t.a", step=1):
            profiling.count("sync.t.a")
            torch.ones(4).sum()
    assert profiling.spans() == [] and profiling.totals() == {} and profiling.counters() == {}
    assert "t.a" not in annotations(prof)


def test_span_on_nests_inherits_ids_and_lands_in_a_trace(tmp_path, tracing):
    @profiling.span("t.deco")
    def deco():
        profiling.count("sync.t.deco", 2)
        assert profiling.open_spans() == ["t.outer", "t.inner", "t.deco"]

    with profiling.trace(tmp_path) as prof:
        with profiling.span("t.outer", step=3) as outer:
            with profiling.span("t.inner", index=2):
                deco()
            with profiling.span("t.sibling"):
                pass
    recs = {r[0]: r for r in profiling.spans()}
    assert [r[0] for r in profiling.spans()] == ["t.deco", "t.inner", "t.sibling", "t.outer"]
    assert recs["t.outer"][4] == 0 and recs["t.outer"][3] == outer.id
    assert recs["t.inner"][4] == outer.id and recs["t.sibling"][4] == outer.id
    assert recs["t.deco"][4] == recs["t.inner"][3]
    assert recs["t.outer"][5] == {"step": 3}
    assert recs["t.inner"][5] == recs["t.deco"][5] == {"step": 3, "index": 2}
    assert recs["t.sibling"][5] == {"step": 3}
    for name, (_, start, end, *_) in recs.items():
        assert start <= end
    assert recs["t.outer"][1] <= recs["t.inner"][1] and recs["t.inner"][2] <= recs["t.outer"][2]
    n, total, own = profiling.totals()["t.outer"]
    inner = profiling.totals()["t.inner"][1] + profiling.totals()["t.sibling"][1]
    assert n == 1 and math.isclose(own, total - inner, abs_tol=1e-9)
    assert profiling.counters() == {"sync.t.deco": 2}
    assert {"t.outer", "t.inner", "t.sibling", "t.deco"} <= annotations(prof)


def test_the_store_is_bounded(monkeypatch, tracing):
    monkeypatch.setattr(profiling, "CAP", 5)
    profiling.reset()
    for i in range(20):
        with profiling.span("t.loop", index=i):
            pass
    kept = profiling.spans()
    assert len(kept) == 5 and [r[5]["index"] for r in kept] == list(range(15, 20))
    assert profiling.totals()["t.loop"][0] == 20
    profiling.reset()
    assert profiling.spans() == [] and profiling.totals() == {}


def test_threads_share_the_store_and_lose_no_update(tracing):
    """16 threads (more than the cores), switching every microsecond: every
    count and every span is kept, each thread's spans nest in its own."""
    def work():
        for i in range(100):
            with profiling.span("t.outer", index=i):
                for _ in range(10):
                    profiling.count("sync.t")
                with profiling.span("t.inner"):
                    assert profiling.open_spans() == ["t.outer", "t.inner"]

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters() == {"sync.t": 16000}
    totals = profiling.totals()
    assert totals["t.outer"][0] == totals["t.inner"][0] == 1600
    parents = {r[3]: r[0] for r in profiling.spans() if r[0] == "t.outer"}
    assert all(parents[r[4]] == "t.outer" for r in profiling.spans() if r[0] == "t.inner")


FLOOD = ("hex.step", [("hex.flood", [])])


def search_part(name):
    return (name, [("search.solve", []), ("search.walk", []),
                   ("search.expand", [FLOOD, ("search.eval", [])]), ("search.backup", [])])


CONFIGS = {
    "K4_grow": dict(nodes=9, leaves_per_pass=4, grow_passes=True),
    "K1": dict(nodes=8),
}


def _train_step(cfg, on):
    profiling.enable(on)
    _, _, init, warmup, step = train.make_train(cfg, device="cpu")
    draws = Draws(0, "cpu")
    state = warmup(init(draws), draws)
    profiling.reset()
    state, aux = step(state, draws)
    records = profiling.spans()
    profiling.enable(False)
    out = {"board": state.worlds.board, "seats": state.worlds.seats, "ptr": state.ptr,
           **{f"aux.{k}": v for k, v in aux.items()},
           **{f"buf.{k}": v for k, v in state.buffer.items() if k != "worlds"},
           **{f"param.{k}": v for k, v in state.model.named_parameters()}}
    return out, records


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_is_the_same_with_tracing_on_and_off(name):
    cfg = train.make_config(3, 8, 1, n_envs=4, buffer_len=3, mix_steps=5, **CONFIGS[name])
    off, none = _train_step(cfg, False)
    on, records = _train_step(cfg, True)
    assert none == []
    assert off.keys() == on.keys()
    for k in off:
        if isinstance(off[k], torch.Tensor):
            torch.testing.assert_close(on[k], off[k], rtol=0, atol=0, equal_nan=True, msg=k)
        else:
            assert on[k] == off[k], k

    mcts = cfg.mcts_config()
    parts = ([search_part("search.pass")] * mcts.n_passes if cfg.leaves_per_pass > 1
             else [search_part("search.sim")] * (cfg.n_nodes - 1))
    assert tree(records) == [
        ("train.step", [("train.actor", [("search.root", [])] + parts + [("train.act", [FLOOD])]),
                        ("train.learner", [])])]
    assert {r[5]["step"] for r in records} == {0}  # the warmup took no learner step
    loop = "search.pass" if cfg.leaves_per_pass > 1 else "search.sim"
    assert [r[5]["index"] for r in records if r[0] == loop] == list(range(len(parts)))


def _league(on, plies):
    profiling.enable(on)
    names = ["a", "b"]
    agents = {}
    for i, n in enumerate(names):
        model = train.build_model(train.make_config(3, 8, 1), device="cpu",
                                  generator=torch.Generator().manual_seed(i))
        agents[n] = MCTSAgent(make_eval_fn(model), n_nodes=4)
    ev = neural.ChunkEvaluator(3, 8, agents, neural.all_matchups(names), 2, seed=0, device="cpu")
    got, trees = [], []
    for _ in range(plies):
        profiling.reset()
        got.append((ev.step(), ev.world.board.clone(), ev.world.seats.clone(), ev.moves))
        trees.append(tree(profiling.spans()))
    profiling.enable(False)
    return got, trees


def test_league_ply_is_the_same_with_tracing_on_and_off():
    off, none = _league(False, 12)
    on, trees = _league(True, 12)
    assert all(t == [] for t in none)
    for (r0, b0, s0, m0), (r1, b1, s1, m1) in zip(off, on):
        assert r0 == r1 and m0 == m1 and torch.equal(b0, b1) and torch.equal(s0, s1)
    assert any(r for r, *_ in on)  # a game finished, so `finish` ran
    search = ("league.search", [("search.root", [])] + [search_part("search.sim")] * 3)
    # the first ply fills every env; a ply that finishes games frees them
    assert trees[0] == [("league.step", [
        ("league.tracker", []), ("league.sync", []), ("league.env", []), ("league.sync", []),
        ("league.tracker", []), search, ("league.env", [FLOOD]), ("league.sync", []),
        ("league.env", []), ("league.sync", [])])]
    finishing = next(t for t, (r, *_) in zip(trees, on) if r)
    assert finishing[0][1][-1] == ("league.tracker", [])


def _board_with_chain(n):
    """A 9x9 world, black to move, with a black chain (1,0)..(1,n-1) that
    touches no edge: black at (0,0) joins it to the top, and the flood runs
    n cells down it. White's stones sit apart on rows 5 and 7."""
    rows = [["."] * 9 for _ in range(9)]
    whites = [(5, c) for c in range(9)] + [(7, c) for c in range(9)]
    for c in range(n):
        rows[1][c] = "b"
    for r, c in whites[:n]:
        rows[r][c] = "w"
    return thex.from_string("\n".join("".join(r) for r in rows), device="cpu")


@pytest.mark.parametrize("n", [0, 3, 4, 5, 8])
def test_flood_counts_each_host_sync(n, monkeypatch, tracing):
    world = _board_with_chain(n)
    calls = []

    def counting_bool(x):
        calls.append(1)
        return bool(x)

    monkeypatch.setattr(thex, "bool", counting_bool, raising=False)
    profiling.reset()
    after, _ = world.step(torch.tensor([0]))  # black at (0, 0), beside the top
    # one check before the loop; a check every 4 dilations until one adds
    # nothing: the chain's n cells take ceil(n/4) growing rounds
    want = 1 + math.ceil(n / 4) + 1
    assert len(calls) == profiling.counters()["sync.hex.flood"] == want
    assert (after.board[0, 1, :n] == thex.TOP).all()

    calls.clear()
    profiling.reset()
    world.step(torch.tensor([4 * 9 + 4]))  # the centre touches no edge: no flood
    assert len(calls) == profiling.counters()["sync.hex.flood"] == 1


def _syncs_warned(fn):
    """(warnings of a synchronizing CUDA operation, sync.* counted) over
    fn()."""
    seen = []

    def show(message, *args, **kwargs):
        if SYNC_WARNING in str(message):
            seen.append(1)

    profiling.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return len(seen), sum(v for k, v in profiling.counters().items() if k.startswith("sync."))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["9x9_K8_grow", "6x6_K1", "league"])
def test_sync_counters_match_the_cards_sync_warnings(name, tracing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from boardlaw_tpu_torch.mcts import kernels

    kernels.build()
    if name == "league":
        agents = {n: MCTSAgent(make_eval_fn(train.build_model(
            train.make_config(9, 32, 1), device="cuda",
            generator=torch.Generator().manual_seed(i))), leaves_per_pass=8, grow_passes=True)
            for i, n in enumerate("ab")}
        ev = neural.ChunkEvaluator(9, 256, agents, neural.all_matchups(list(agents)), 10**9,
                                   seed=0, device="cuda")
        ev.step()
        warned, counted = _syncs_warned(lambda: [ev.step() for _ in range(2)])
    else:
        board, width, depth = (9, 32, 1) if name.startswith("9x9") else (6, 32, 1)
        cfg = train.make_config(board, width, depth, n_envs=256, buffer_len=4, mix_steps=10)
        _, _, init, warmup, step = train.make_train(cfg, device="cuda")
        draws = Draws(0, "cuda")
        state = warmup(init(draws), draws)
        state, _ = step(state, draws)  # Adam's state made

        def steps():
            nonlocal state
            for _ in range(2):
                state, aux = step(state, draws)
                train._host_scalars(aux)

        warned, counted = _syncs_warned(steps)
    assert warned == counted > 0
