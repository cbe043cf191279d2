"""The port's results database (`sql`), its agents by row
(`arena.common.sql_agent`/`sql_world`), `arena.best` and the readers of
`arena.mohex_calibration` against the JAX package's, on the CPU.

* `refresh` of the port and of the JAX package over one registry (runs the
  JAX package wrote and a run the port wrote) fill identical tables.
* The port reads a database the JAX package wrote: every query's
  `Rows.frame()` equals the JAX package's DataFrame under
  `pd.testing.assert_frame_equal` (columns, index and dtypes), empty
  queries and NULL columns included; the JAX package reads what the port
  writes.
* `sql_agent` searches with the row's `test_nodes` and the run's c_puct
  (the row's `test_c` is not applied, as in the JAX package), and on a run
  the JAX package wrote gives the JAX agent's actions under JAX's draws.
* `best.rating_std` equals JAX's to 1e-12; `top_agent` and
  `std_available` give JAX's agents, with the stds to 1e-6 (they are
  counts; only the top agent comes from a solve).
* `calibrations`/`best_agent` give JAX's agents and win rates.
"""
import sqlite3

import numpy as np
import jax
import pandas as pd
import pytest
import torch

from boardlaw_tpu import sql as jsql
from boardlaw_tpu.arena import best as jbest, common as jcommon, \
    mohex_calibration as jmohex_calibration
from boardlaw_tpu.pavlov import runs as jruns, storage as jpstorage
from boardlaw_tpu_torch import sql, train
from boardlaw_tpu_torch.arena import best, common, mohex_calibration
from boardlaw_tpu_torch.pavlov import storage as pstorage
from boardlaw_tpu_torch.pavlov.tests import mock_dir
from test_torch_arena import _port_world
from test_torch_run import TINY, _jax_payload
from test_torch_search_k1 import JaxK1Draws

torch.set_num_threads(2)

TABLES = ("runs", "snaps", "agents", "trials", "mohex_trials", "noise_scales")


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("BOARDLAW_DB", str(tmp_path / "db.sql"))
    yield tmp_path


@pytest.fixture(scope="module")
def payload():
    """A JAX `init` state after one optax update, as the JAX package's
    storer payload (one JAX `init` compile for the file)."""
    from boardlaw_tpu import train as jtrain

    jcfg = jtrain.TrainConfig(boardsize=3, width=4, depth=1, n_envs=8, n_nodes=8,
                              buffer_len=4, mix_steps=16)
    return jcfg, _jax_payload(jcfg)[1]


def _jax_run(payload, snaps=2):
    """A 3x3 run the JAX package wrote: model file, latest and `snaps`
    snapshots of `payload`."""
    jcfg, sd = payload
    run = jruns.new_run(description="jax/3", boardsize=3, width=4, depth=1, nodes=8,
                        c_puct=1 / 16)
    jpstorage.save_raw(run, "model", {"cfg": jcfg.__dict__, "kind": "FCModel"})
    jpstorage.save_latest(run, sd)
    for i in range(snaps):
        jpstorage.save_snapshot(run, sd, n_samples=10.0 * (i + 1), n_flops=1e9 * 4 ** i)
    return run


def _tables(path):
    conn = sqlite3.connect(path)
    try:
        return {t: conn.execute(f"select * from {t} order by id"
                                if t != "runs" else "select * from runs order by run").fetchall()
                for t in TABLES}
    finally:
        conn.close()


def test_refresh_matches_jax(tmp_path, monkeypatch, payload):
    with mock_dir():
        _jax_run(payload)
        jruns.new_run(description="no boardsize")  # skipped by both
        prun = train.run(max_steps=1, **TINY)
        pstorage.save_snapshot(prun, {"agent": pstorage.load_latest(prun)["agent"]},
                               n_samples=8.0, n_flops=1e6)
        tables = {}
        for name, module in (("jax", jsql), ("port", sql)):
            monkeypatch.setenv("BOARDLAW_DB", str(tmp_path / f"{name}.sql"))
            module.refresh()
            module.refresh()  # a second refresh adds nothing
            tables[name] = _tables(tmp_path / f"{name}.sql")
    assert tables["port"] == tables["jax"]
    assert len(tables["port"]["runs"]) == 2 and len(tables["port"]["agents"]) == 3


def _assert_frames(got, want):
    pd.testing.assert_frame_equal(got.frame(), want)


def test_port_reads_a_database_jax_wrote(db, payload):
    with mock_dir():
        _jax_run(payload)
        jsql.refresh()
        ids = list(jsql.agent_query().index)
        jsql.save_trials([(ids[0], ids[1], 3, 1, 40, 1.5), (ids[1], ids[0], 2, 2, 30, 0.5)])
        jsql.save_mohex_trials([(ids[0], None, 2, 2, 30, 1.0), (None, ids[1], 1, 3, 20, 2.0)])
        jsql.save_noise_scale(ids[0], "policy", mean_sq=1.0, sq_mean=0.5, variance=0.5,
                              n_params=100, batch_size=32, batches=8)

        _assert_frames(sql.agent_query(), jsql.agent_query())
        _assert_frames(sql.trial_query(3), jsql.trial_query(3))
        _assert_frames(sql.trial_query(3, "jax/%"), jsql.trial_query(3, "jax/%"))
        _assert_frames(sql.trial_query(5), jsql.trial_query(5))  # empty
        _assert_frames(sql.mohex_trial_query(), jsql.mohex_trial_query())
        q = "select * from noise_scales where agent_id == ?"
        _assert_frames(sql.query(q, ids[0]), jsql.query(q, ids[0]))

        rows = sql.agent_query()
        assert len(rows) == 2 and list(rows.index) == ids
        row = rows.row(ids[1])
        assert (row.boardsize, row.test_nodes, row.train_flops) == (3, 8, 4e9)
        with pytest.raises(KeyError):
            rows.row(99)
        trials = sql.trial_query(3)
        assert trials.black_wins.tolist() == [3, 2] and trials.take([1]).moves.tolist() == [30]

        # and the JAX package reads what the port writes
        sql.save_trials([(ids[0], ids[1], 0, 4, 12, 0.25)])
        sql.save_noise_scale(ids[1], "value", mean_sq=2.0, batches=4)
        _assert_frames(sql.trial_query(3), jsql.trial_query(3))
        assert len(jsql.query(q, ids[1])) == 1


def test_sql_agent_and_world(db, payload):
    with mock_dir():
        run = _jax_run(payload)
        sql.refresh()
        aid = int(sql.agent_query().index[0])
        # a row with its own test search: test_nodes applies, test_c does not
        sql.execute("insert into agents values (null, ?, ?, ?)",
                    int(sql.agent_query().row(aid).snap_id), 4, 0.5)
        other = int(sql.agent_query().index[-1])
        ag = common.sql_agent(other, device="cpu")
        assert (ag.search.cfg.n_nodes, ag.search.cfg.c_puct) == (4, 1 / 16)
        assert common.sql_agent(other, device="cpu", leaves_per_pass=2).search.cfg \
            .leaves_per_pass == 2

        world = common.sql_world(aid, 6, device="cpu")
        assert world.board.shape == (6, 3, 3) and world.device.type == "cpu"

        # the row's agent plays as the JAX package's sql_agent
        jag, jworld = jcommon.sql_agent(aid), jcommon.sql_world(aid, 4)
        key = jax.random.PRNGKey(3)
        want = np.asarray(jag(jworld, key, eval=True)["actions"])
        got = common.sql_agent(aid, device="cpu")(
            _port_world(jworld), JaxK1Draws(jax.random.split(key)[0], 7), eval=True)["actions"]
        np.testing.assert_array_equal(got.numpy(), want)
        assert run in sql.agent_query().run.tolist()


def _league_db(seed, n_agents=5):
    """A database of `n_agents` snapshots of one 3x3 run with random trials
    between them (written by the JAX package)."""
    run = jruns.new_run(description="league", boardsize=3, width=4, depth=1, nodes=8)
    for i in range(n_agents):
        jpstorage.save_snapshot(run, {"x": np.ones(2)}, n_samples=10.0 * (i + 1),
                                n_flops=1e9 * 2 ** i)
    jsql.refresh()
    ids = list(jsql.agent_query().index)
    rng = np.random.default_rng(seed)
    skill = np.linspace(1.5, -1.5, n_agents)
    rows = []
    for i, b in enumerate(ids):
        for j, w in enumerate(ids):
            if i != j and rng.random() < 0.8:
                n = int(rng.integers(1, 12))
                bw = int(rng.binomial(n, 1 / (1 + np.exp(-(skill[i] - skill[j])))))
                rows.append((b, w, bw, n - bw, 10 * n, 0.1 * n))
    jsql.save_trials(rows)
    return ids


@pytest.mark.parametrize("seed", [0, 1])
def test_best_matches_jax(db, seed):
    wins, losses = np.meshgrid(np.arange(0, 40, 3.0), np.arange(0, 25, 2.0))
    np.testing.assert_allclose(best.rating_std(wins, losses), jbest.rating_std(wins, losses),
                               rtol=1e-12, atol=0)
    with mock_dir():
        assert best.top_agent(3, device="cpu") is None and len(best.std_available(3)) == 0
        _league_db(seed)
        assert best.top_agent(3, device="cpu") == int(jbest.top_agent(3))
        for max_std in (0.5, 0.8):
            got = best.std_available(3, max_std=max_std, device="cpu")
            want = jbest.std_available(3, max_std=max_std)
            order = np.argsort(got.agent)
            want = want.sort_values("agent")
            assert got.agent[order].tolist() == want.agent.astype(int).tolist()
            np.testing.assert_allclose(got.std[order], want["std"], rtol=1e-6)
            np.testing.assert_array_equal(got.games[order], want.games)
            assert (np.diff(got.std) <= 0).all()


def test_calibration_readers_match_jax(db):
    assert len(mohex_calibration.calibrations(3)) == 0
    assert mohex_calibration.best_agent(3) is None
    rows = [(3, None, 5, 3, 80, 1.0), (None, 3, 4, 4, 70, 1.0), (5, None, 1, 7, 60, 1.0),
            (None, 5, 6, 2, 50, 1.0), (7, None, 8, 0, 40, 1.0)]
    jsql.save_mohex_trials(rows)
    got, want = mohex_calibration.calibrations(9), jmohex_calibration.calibrations(9)
    want = want.assign(agent_id=want.agent_id.astype(int)).sort_values("agent_id")
    assert got.agent_id.tolist() == want.agent_id.tolist() == [3, 5, 7]
    np.testing.assert_allclose(got.winrate, want.winrate, rtol=1e-12)
    np.testing.assert_array_equal(got.games, want.games)
    assert mohex_calibration.best_agent(9) == int(jmohex_calibration.best_agent(9)) == 7
