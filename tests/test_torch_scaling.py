"""The port's scaling analysis (`scaling/`) and study script
(`scripts/torch_scaling_study.py`) against the JAX package's, on the CPU,
on the data of `tests/test_sql_scaling.py` and `tests/test_analysis.py`.

* `interp_curves`/`interp_frontier`, `train_test`/`train_test_model` and
  `sample_calibrations` equal JAX's frames to 1e-12 (the same float64
  numpy and pandas arithmetic), and `best.frontier_participants` picks
  JAX's agents.
* `changepoint_apply`/`sigmoid_apply` equal JAX's to 1e-6 (float32).
* `fit_model`: differential evolution follows the float32 loss's values, so
  the two fits' parameters are not compared; the port's fit of
  `test_changepoint_fit`'s data has RMSE under 0.1 and within 10% of the
  JAX fit's. `perfect_play` of one set of parameters agrees to 1e-4 log10
  FLOPs (a bisection on float32 model values).
* `load`, `inflation` and `transitive` equal JAX's to 1e-6 on one database,
  both packages' Elo solves running JAX's solver on the same matrices (the
  solvers are held against each other in `tests/test_torch_elos.py`).
  JAX's `symmetrize` gives NaN games to every pair of an agent that never
  played white; the port counts them. That quirk is pinned on its own.
* The paper figures render under Agg, and the study's stages run at
  `tests/test_scaling_study.py`'s toy scale with no JAX training.
"""
import argparse
import os
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import matplotlib
import pandas as pd
import pytest
import torch

matplotlib.use("Agg")

from boardlaw_tpu import elos as jelos, sql as jsql  # noqa: E402
from boardlaw_tpu.pavlov import runs as jruns, storage as jpstorage  # noqa: E402
from boardlaw_tpu.scaling import data as jdata, inflation as jinflation, \
    transitive as jtransitive  # noqa: E402
from boardlaw_tpu_torch import elos, sql, train  # noqa: E402
from boardlaw_tpu_torch.pavlov import storage as pstorage  # noqa: E402
from boardlaw_tpu_torch.pavlov.tests import mock_dir  # noqa: E402
from boardlaw_tpu_torch.scaling import data, inflation, paper, transitive  # noqa: E402
from scripts import torch_scaling_study as study  # noqa: E402
from test_analysis import _synthetic_ags  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("BOARDLAW_DB", str(tmp_path / "db.sql"))
    yield tmp_path


def _two_runs():
    return pd.DataFrame({"run": ["a"] * 3 + ["b"] * 3,
                         "train_flops": [1e9, 1e10, 1e11] * 2,
                         "elo": [-3, -2, -1, -2.5, -1.5, -0.5]})


@pytest.mark.parametrize("ags", [_two_runs(), _synthetic_ags()], ids=["two_runs", "synthetic"])
def test_interp_matches_jax(ags):
    pd.testing.assert_frame_equal(data.interp_curves(ags), jdata.interp_curves(ags),
                                  rtol=1e-12, atol=1e-12)
    got, want = data.interp_frontier(ags), jdata.interp_frontier(ags)
    pd.testing.assert_series_equal(got, want, rtol=1e-12, atol=1e-12)
    if len(ags) == 6:
        assert got.iloc[-1] == -0.5 and (got.diff().dropna() >= -1e-9).all()


def test_frontier_participants_match_jax():
    from boardlaw_tpu.arena import best as jbest
    from boardlaw_tpu_torch.arena import best

    ags = _synthetic_ags()
    for b in (5, 7, 9):
        assert sorted(best.frontier_participants(ags, b)) == \
            sorted(jbest.frontier_participants(ags, b))
    assert len(best.frontier_participants(ags, 7)) > 0


def test_train_test_matches_jax():
    ags = _synthetic_ags()
    got, want = data.train_test(ags), jdata.train_test(ags)
    pd.testing.assert_frame_equal(got, want, rtol=1e-12)
    (f, coef), (jf, jcoef) = data.train_test_model(got), jdata.train_test_model(want)
    pd.testing.assert_frame_equal(f, jf, rtol=1e-12)
    pd.testing.assert_series_equal(coef, jcoef, rtol=1e-12)


@pytest.mark.parametrize("model", ["changepoint", "sigmoid"])
def test_models_match_jax(model):
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(8, 16, 64), rng.integers(3, 10, 64)], -1).astype(np.float32)
    init = getattr(data, f"{model}_init")()
    params = {k: (v + torch.tensor(rng.normal(0, 0.3, v.shape), dtype=torch.float32))
              for k, v in init.items()}
    got = getattr(data, f"{model}_apply")(params, torch.tensor(X))
    want = getattr(jdata, f"{model}_apply")({k: jnp.asarray(v.numpy()) for k, v in
                                             params.items()}, jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    df = pd.DataFrame({"train_flops": 10.0 ** X[:, 0], "boardsize": X[:, 1]})
    np.testing.assert_allclose(data.model_inputs(df).numpy(), np.asarray(jdata.model_inputs(df)),
                               rtol=1e-6)


def _changepoint_data():
    """`tests/test_sql_scaling.py::test_changepoint_fit`'s frontier."""
    rng = np.random.default_rng(0)
    flops = np.logspace(9, 15, 40)
    rows = []
    for b in [5, 7]:
        plateau = -0.1 * b
        elo = np.maximum(np.minimum(1.2 * (np.log10(flops) - 9) - 0.9 * b, 0), plateau)
        for f, e in zip(flops, elo):
            rows.append({"boardsize": b, "train_flops": f, "elo": e + rng.normal(0, 0.01)})
    return pd.DataFrame(rows)


def test_fit_model_and_perfect_play():
    df = _changepoint_data()
    # the fit's core takes any object with the three arrays (no pandas)
    arrays = SimpleNamespace(**{k: df[k].to_numpy() for k in ("train_flops", "boardsize", "elo")})
    params = data.fit_model(arrays, device="cpu")
    rmse = float(np.sqrt(((df.elo - data.apply_model(params, df)) ** 2).mean()))
    jparams = jdata.fit_model(df)
    jrmse = float(np.sqrt(((df.elo - jdata.apply_model(jparams, df)) ** 2).mean()))
    assert rmse < 0.1 and abs(rmse - jrmse) <= 0.1 * jrmse, (rmse, jrmse)

    # one set of parameters: the port's perfect_play equals JAX's
    got = data.perfect_play(params)
    want = jdata.perfect_play({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    assert list(got) == list(want.index)
    np.testing.assert_allclose(list(got.values()), want.values, atol=1e-4)


def _shared_solve(ws, gs, prior=1.0, device=None):
    """The port's `elos.solve` signature over JAX's solver."""
    return jelos.solve(pd.DataFrame(ws), pd.DataFrame(gs), prior).values


def _league(seed=0, n_agents=5):
    """A 3x3 league in a database the JAX package writes: two runs'
    snapshots, random trials, and MoHex trials."""
    rng = np.random.default_rng(seed)
    for r in range(2):
        run = jruns.new_run(description="study", boardsize=3, width=4 * (r + 1), depth=1,
                            nodes=8)
        for i in range(n_agents // 2 + r):
            jpstorage.save_snapshot(run, {"x": np.ones(2)}, n_samples=8.0 * (i + 1),
                                    n_flops=1e9 * 3 ** i * (r + 1))
    jsql.refresh()
    ids = list(jsql.agent_query().index)
    rows = []
    for b in ids:
        for w in ids:
            if b != w and rng.random() < 0.85:
                n = int(rng.integers(2, 12))
                bw = int(rng.binomial(n, 1 / (1 + np.exp(-0.4 * (b - w)))))
                rows.append((b, w, bw, n - bw, 10 * n, 0.1 * n))
    # in the order a league's rounds would write them
    jsql.save_trials([rows[i] for i in rng.permutation(len(rows))])
    jsql.save_mohex_trials([(ids[0], None, 5, 3, 80, 1.0), (None, ids[0], 4, 4, 70, 1.0),
                            (ids[-1], None, 7, 1, 60, 1.0)])
    return ids


def test_database_analyses_match_jax(db, monkeypatch):
    monkeypatch.setattr(elos, "solve", _shared_solve)
    with mock_dir():
        _league()
        got, want = data.load(), jdata.load()
        pd.testing.assert_frame_equal(got, want, check_names=False, rtol=1e-6)
        pd.testing.assert_frame_equal(inflation.inflation(3), jinflation.inflation(3),
                                      check_names=False, rtol=1e-6, atol=1e-6)
        got, want = transitive.residuals(3), jtransitive.residuals(3)
        np.testing.assert_allclose(got.values, want.values, rtol=1e-6, atol=1e-6)
        assert list(got.index) == list(want.index)
        got, want = transitive.worst_triangles(3, 5), jtransitive.worst_triangles(3, 5)
        np.testing.assert_allclose(got.values, want.values, rtol=1e-6, atol=1e-6)
        pd.testing.assert_frame_equal(data.sample_calibrations(), jdata.sample_calibrations(),
                                      rtol=1e-12)
        assert len(inflation.inflation(5)) == 0 and transitive.residuals(5).empty


def test_symmetrize_of_an_agent_that_never_played_white():
    """The JAX package's `symmetrize` gives NaN games to every pair of an
    agent that never played white (its `reindex(columns=ids, level=1)`
    adds no column), and its `solve` then leaves that agent out of the
    likelihood; the port counts the agent's games. Pinned here, and noted
    among the reference's quirks."""
    trials = pd.DataFrame({"black_agent": [1, 1, 2], "white_agent": [2, 3, 3],
                           "black_wins": [3.0, 2.0, 1.0], "white_wins": [1.0, 2.0, 3.0]})
    _, jgs = jelos.symmetrize(trials)
    ws, gs, names = elos.symmetric_matrices(trials)
    assert np.isnan(jgs.values[0]).all() and np.isnan(jgs.values[:, 0]).all()
    np.testing.assert_array_equal(gs, [[0, 4, 4], [4, 0, 4], [4, 4, 0]])
    np.testing.assert_array_equal(jgs.values[1:, 1:], gs[1:, 1:])


def test_paper_figures_render(db):
    ags = _synthetic_ags()
    for fn in (paper.flops_curves, paper.train_test, paper.optimal_model_size):
        assert fn(ags) is not None
    for fn in (paper.frontiers, paper.residual_vars):
        assert fn(ags, device="cpu") is not None
    assert paper.hex_board(boardsize=5, n_moves=6) is not None
    assert paper.calibrations() is not None
    assert len(paper.hyperparams_table()) == 7
    assert len(paper.boardsize_hyperparams_table(ags)) == 2


def test_scaling_study_pipeline(db, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # fit() writes output/ under cwd
    args = argparse.Namespace(boardsize=3, envs=8, steps=2, sizes="4:1,8:1", envs_per=2,
                              league_envs=8, k=1, dtype="float32", test_k=1, seed=0,
                              device="cpu")
    with mock_dir():
        # the toy runs take no snapshot of their own at these FLOPs: register
        # two FLOP points a run, as tests/test_scaling_study.py does
        for width, depth in study.parse_sizes(args.sizes):
            run = train.run(args.boardsize, width, depth, desc=study.DESC, n_envs=args.envs,
                            nodes=4, mix_steps=4, buffer_len=4, max_steps=args.steps,
                            storer="flops", device="cpu")
            sd = pstorage.load_latest(run)
            f0 = 1e9 * (width / 4)
            pstorage.save_snapshot(run, {"agent": sd["agent"]}, n_samples=8.0, n_flops=f0)
            pstorage.save_snapshot(run, {"agent": sd["agent"]}, n_samples=16.0, n_flops=4 * f0)

        trials = study.evaluate(args)
        assert len(trials) == 12
        rows = sql.trial_query(args.boardsize, study.DESC)
        n_agents = len(sql.agent_query())
        assert n_agents == 4 and len(rows) == n_agents * (n_agents - 1)
        assert (rows.black_wins + rows.white_wins > 0).all()

        # a rerun adds nothing: every matchup has been played
        assert study.evaluate(args) is None
        assert len(sql.trial_query(args.boardsize, study.DESC)) == len(rows)

        study.fit(args)
        for name in ("frontier_b3.csv", "flops_curves_b3.png", "fit_b3.json"):
            assert os.path.exists(f"output/experiments/scaling/{name}")
