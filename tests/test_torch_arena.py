"""The port's evaluation (arena/, pavlov/json_store.py) against the JAX
package's, on the CPU at 3x3.

* `common.evaluate` equals JAX's game for game under the same draws: with
  `MockAgent`s (a fixed move, capped at `max_plies`), with uniform random
  agents, and with two K=1 MCTS agents on converted params; the port's
  agents take `draws.split()` where JAX's take a split key, fed here from
  JAX's key tree. Wins, moves and games are equal (the times are each
  package's own).
* `Tracker` makes JAX's assignments step for step; `chunk_jobs` JAX's
  jobs; `ChunkEvaluator`/`neural.evaluate` JAX's trials under the same
  draws.
* `common.agent` loads a run of the port's and a run the JAX package wrote
  (a JAX `init` state after one optax update; no JAX `train_step` is
  compiled): its search under JAX's draws gives JAX's agent's actions.
* `perfect.Solver` gives JAX's values and optimal moves, and
  `exact_opening_wins` JAX's labels.
* `RollingArena.play` grows the ledger, solves the posterior and writes
  `elo-arena`; `json_store` reads what the JAX package wrote and the JAX
  package reads what it writes.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from boardlaw_tpu import train as jtrain
from boardlaw_tpu.arena import common as jcommon, neural as jneural, perfect as jperfect
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.pavlov import json_store as jjson, runs as jruns, storage as jpstorage
from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.arena import common, live, neural, perfect
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import search as TS
from boardlaw_tpu_torch.pavlov import json_store, runs, stats
from boardlaw_tpu_torch.pavlov.tests import mock_dir
from test_torch_run import TINY, _jax_payload
from test_torch_search import _models, _t
from test_torch_search_k1 import JaxK1Draws

torch.set_num_threads(2)


class FedDraws(Draws):
    """A JAX key as the port's draws: `split()` splits the key as the JAX
    code splits it for an agent's call, and hands the subkey to `child`,
    which makes the agent's draws from it."""

    def __init__(self, key, child):
        self.device = torch.device("cpu")
        self.key, self.child = key, child

    def split(self):
        self.key, sub = jax.random.split(self.key)
        return self.child(sub)


class GumbelDraws(Draws):
    """`jax.random.categorical(key, logits)` as the port draws it:
    argmax(logits + gumbel)."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        self.key = key

    def gumbel(self, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(self.key, tuple(shape))))


def _jax_random_agent(world, key, eval=False):
    valid = world.valid
    logits = jnp.where(valid, -jnp.log(valid.sum(-1, keepdims=True)), -jnp.inf)
    return {"actions": jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)}


def _jax_worlds(B, plies, seed):
    """3x3 worlds `plies` random moves in, so the seats to play differ (and
    the agents' buckets are uneven)."""
    rng = np.random.default_rng(seed)
    world = jhex.Hex.initial(B, 3)
    for ply in range(plies):
        moving = rng.random(B) < 0.5
        valid = np.asarray(world.valid)
        a = np.array([rng.choice(np.flatnonzero(v)) for v in valid], np.int32)
        stepped, _ = world.step(jnp.asarray(a))
        world = jax.tree.map(lambda s, w: jnp.where(
            jnp.asarray(moving).reshape((-1,) + (1,) * (s.ndim - 1)), s, w), stepped, world)
    return world


def _port_world(jworld):
    return thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))


def _same_results(tres, jres):
    assert len(tres) == len(jres) == 2
    for t, j in zip(tres, jres):
        for k in ("names", "wins", "moves", "games", "boardsize"):
            assert t[k] == j[k], (k, t, j)


def test_evaluate_mock_agents_match_jax():
    jworld = _jax_worlds(8, 2, 0)
    jres = jcommon.evaluate(jworld, {"four": jneural.MockAgent(4), "zero": jneural.MockAgent(0)},
                            max_plies=12)
    tres = common.evaluate(_port_world(jworld),
                           {"four": neural.MockAgent(4), "zero": neural.MockAgent(0)},
                           max_plies=12)
    _same_results(tres, jres)


@pytest.mark.parametrize("seed,plies", [(1, 0), (2, 3)])
def test_evaluate_random_agents_match_jax(seed, plies):
    jworld = _jax_worlds(16, plies, seed)
    key = jax.random.PRNGKey(seed)
    jres = jcommon.evaluate(jworld, {"a": _jax_random_agent, "b": _jax_random_agent}, key=key)
    tres = common.evaluate(_port_world(jworld), {"a": live._random_agent(),
                                                 "b": live._random_agent()},
                           draws=FedDraws(key, GumbelDraws))
    _same_results(tres, jres)
    assert sum(r["games"] for r in tres) == 16


def test_evaluate_mcts_agents_match_jax():
    n_nodes, B, seed = 6, 8, 3
    (jeval_a, teval_a), (jeval_b, teval_b) = (_models(boardsize=3, seed=s) for s in (5, 6))
    jagents = {}
    for name, jeval in (("a", jeval_a), ("b", jeval_b)):
        jag = S.MCTSAgent(jeval, n_nodes=n_nodes, use_pallas=False, pallas_nodes=False,
                          pallas_walk=False)
        jagents[name] = jax.jit(lambda w, k, eval=True, jag=jag: jag(w, k, eval=True))
    jworld = _jax_worlds(B, 1, seed)
    key = jax.random.PRNGKey(seed)
    jres = jcommon.evaluate(jworld, jagents, key=key)

    tagents = {"a": TS.MCTSAgent(teval_a, n_nodes=n_nodes),
               "b": TS.MCTSAgent(teval_b, n_nodes=n_nodes)}
    # the JAX agent splits its key into the search's and the action's
    child = lambda sub: JaxK1Draws(jax.random.split(sub)[0], n_nodes - 1)  # noqa: E731
    tres = common.evaluate(_port_world(jworld), tagents, draws=FedDraws(key, child))
    _same_results(tres, jres)
    assert sum(r["games"] for r in tres) == B


def test_tracker_matches_jax():
    rng = np.random.default_rng(0)
    matchups = neural.all_matchups(["a", "b", "c"])
    assert matchups == jneural.all_matchups(["a", "b", "c"])
    jt, tt = jneural.Tracker(8, matchups, 3), neural.Tracker(8, matchups, 3)
    for _ in range(12):
        np.testing.assert_array_equal(tt.refill(), jt.refill())
        seats = rng.integers(0, 2, 8)
        (jn, jm), (tn, tm) = jt.suggest(seats), tt.suggest(seats)
        assert jn == tn and np.array_equal(jm, tm)
        done = np.flatnonzero(rng.random(8) < 0.4)
        assert tt.finish(done) == jt.finish(done)
        assert tt.remaining == jt.remaining and tt.finished == jt.finished
        np.testing.assert_array_equal(tt.live, jt.live)


def test_chunk_jobs_and_max_envs():
    specs = {f"a{i}": i for i in range(5)}
    assert neural.chunk_jobs(specs, 2) == jneural.chunk_jobs(specs, 2)
    # the port's bytes per env: four (T, A) rows at the dtype rule's widths
    # (16 bytes a slot wide, 11 compact), the node statistics and worlds
    assert neural.env_bytes(9, 513, 8) == 513 * (81 * 16 + 41 + 81 + 4)
    assert neural.env_bytes(9, 64) == 64 * (81 * 11 + 41 + 81 + 4)
    assert neural.max_envs(9, 64, memory_bytes=2**30) == 2**29 // neural.env_bytes(9, 64) // 2 * 2
    # the jobs' arguments, but for the loader (each package's own)
    for t, j in zip(neural.evaluate_gen(3, specs, chunk_size=2),
                    jneural.evaluate_gen(3, specs, chunk_size=2), strict=True):
        assert t[:2] + t[3:] == j[:2] + j[3:]


def test_league_matches_jax(monkeypatch):
    agents = {n: live._random_agent() for n in "abc"}
    jtrials = jneural.evaluate(3, {n: _jax_random_agent for n in "abc"}, n_envs_per=2, n_envs=6,
                               seed=4)
    monkeypatch.setattr(neural, "Draws",
                        lambda seed, device: FedDraws(jax.random.PRNGKey(seed), GumbelDraws))
    trials = neural.evaluate(3, agents, n_envs_per=2, n_envs=6, seed=4, device="cpu")
    assert isinstance(trials, neural.Trials) and len(trials) == 6
    key = ["black_agent", "white_agent"]
    pd.testing.assert_frame_equal(trials.frame().sort_values(key).reset_index(drop=True),
                                  jtrials.sort_values(key).reset_index(drop=True))
    assert ((trials.black_wins + trials.white_wins) == 2).all()


def _save_jax_run():
    """A run the JAX package wrote: its model file and a latest checkpoint
    of a JAX `init` state after one optax update."""
    jcfg = jtrain.TrainConfig(boardsize=3, width=4, depth=1, n_envs=8, n_nodes=8,
                              buffer_len=4, mix_steps=16)
    _, payload = _jax_payload(jcfg)
    run = jruns.new_run(description="written by the JAX package", boardsize=3)
    jpstorage.save_raw(run, "model", {"cfg": jcfg.__dict__, "kind": "FCModel"})
    jpstorage.save_latest(run, payload)
    return run


def test_agent_loads_port_and_jax_runs():
    with mock_dir():
        prun = train.run(max_steps=1, **TINY)
        jrun = _save_jax_run()
        world = common.worlds(prun, 4, device="cpu")
        for run in (prun, jrun):
            ag = common.agent(run, device="cpu")
            assert isinstance(ag, common.SharedParamsAgent)
            out = ag(world, Draws(0, "cpu"), eval=True)
            assert out["actions"].shape == (4,) and world.valid[torch.arange(4), out["actions"]
                                                               .long()].all()
        assert common.agent(prun, device="cpu").model is ag.model  # one module per architecture
        results = common.evaluate(world, {"port": common.agent(prun, device="cpu"),
                                          "jax": common.agent(jrun, device="cpu")})
        assert sum(r["games"] for r in results) == 4
        # the JAX-written run's agent searches as the JAX package's agent does
        jag = jcommon.agent(jrun)
        jworld = jcommon.worlds(jrun, 4)
        key = jax.random.PRNGKey(7)
        want = np.asarray(jag(jworld, key, eval=True)["actions"])
        got = common.agent(jrun, device="cpu")(
            _port_world(jworld), JaxK1Draws(jax.random.split(key)[0], 7), eval=True)["actions"]
        np.testing.assert_array_equal(got.numpy(), want)
        assert common.agent(runs.new_run(), device="cpu") is None  # no model file


def test_perfect_solver_matches_jax():
    jsolver, tsolver = jperfect.Solver(3), perfect.Solver(3, device="cpu")
    world = _jax_worlds(12, 3, 8)
    for b in range(12):
        board, seat = np.asarray(world.board[b]), int(world.seats[b])
        if (board != 0).all():
            continue
        assert tsolver.value(board, seat) == jsolver.value(board, seat)
        np.testing.assert_array_equal(tsolver.optimal_actions(board, seat),
                                      jsolver.optimal_actions(board, seat))
    jwins, jopen = jperfect.exact_opening_wins(3, cache=False)
    twins, topen = perfect.exact_opening_wins(3, cache=False, device="cpu")
    np.testing.assert_array_equal(twins, jwins)
    np.testing.assert_array_equal(topen.board.numpy(), np.asarray(jopen.board))
    # perfect play: black (the first mover) wins every 3x3 game
    solver = perfect.Solver(3, device="cpu")
    res = common.evaluate(thex.Hex.initial(4, 3, device="cpu"),
                          {"p": perfect.PerfectAgent(solver), "q": perfect.PerfectAgent(solver, 1)})
    assert [r["wins"] for r in res] == [(2.0, 0.0), (2.0, 0.0)]


def test_rolling_arena_and_json_store():
    with mock_dir():
        run = train.run(max_steps=1, **TINY)
        ladder = {"rollout-1": live._random_agent(), **live.rollout_ladder((4,))}
        arena = live.RollingArena(run, n_envs=4, ladder=ladder, device="cpu")
        with stats.to_run(run):
            rels = [arena.play(), arena.play()]
        assert all(np.isfinite(r) for r in rels)
        trials = live.ledger_trials(run)
        assert (trials.black_wins + trials.white_wins).sum() == 8
        assert "elo-arena" in stats.channels(run)
        assert arena.soln.names == ["latest", "rollout-1", "rollout-4"]
        # the second round played the most informative rung after round one
        n, w = live.symmetric_counts(trials, arena.soln.names)
        nf, wf = live.symmetric_counts(trials.frame(), arena.soln.names)
        np.testing.assert_array_equal(nf.values, n)
        np.testing.assert_array_equal(wf.values, w)
        assert n[0].sum() == 8 and (w + w.T == n).all()

        # json_store: the JAX package reads the port's ledger and the port JAX's
        assert jjson.read(run, live.LEDGER) == json_store.read(run, live.LEDGER)
        jjson.update(run, "jax-written", lambda o: o.update(x=1))
        assert json_store.update(run, "jax-written", lambda o: o.update(y=2)) == {"x": 1, "y": 2}
        assert jjson.read(run, "jax-written") == {"x": 1, "y": 2}
        assert json_store.read(run, "missing", default=[]) == []
        assert json_store.path(run, "a") == jjson.path(run, "a")
