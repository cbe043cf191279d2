"""The port's rollouts and recordings (`analysis`), `mohex_calibration`'s
play-out and calibration, the arena posterior's analysis (`arena/analysis`)
and the activelo demos (`activelo/examples`, `activelo/plot`) against the
JAX package's, on the CPU.

* `rollout` under a deterministic agent (the first valid cell): actions,
  boards, transitions and the combined decisions equal JAX's bit for bit,
  for each stopping rule; `record_worlds` renders JAX's frames.
* `mohex_calibration.play_out` of `PerfectAgent` against itself on 3x3:
  black wins every game (`tests/test_perfect.py`'s case); `reference_wins`
  labels all 72 openings of 3x3 against the stub engine and reads them
  back from its cache; `calibrate`
  against the GTP stub engine (`tests/gtp_stub.py`) writes one
  `mohex_trials` row a seat order, MoHex's seat as None, and the JAX
  package's readers agree with the port's.
* The demos and the arena analysis solve `activelo` in float32 with L-BFGS
  in both packages: the means, gaps and their stds agree to atol 2e-3, the
  covariance to rtol 2e-2 (so the stds to 1e-2), and the suggested pairs
  are JAX's (`tests/test_torch_elos.py`'s tolerances) up to a tie of the
  symmetric gain matrix, where the two orientations of one pair tie. `simulate`'s rounds each
  warm-start from the last round's solution, so their float32 gaps add up:
  its means agree to atol 5e-3 over six rounds, its suggestions exactly.
  The figures render under Agg.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import matplotlib
import pytest
import torch

matplotlib.use("Agg")

from boardlaw_tpu import analysis as janalysis  # noqa: E402
from boardlaw_tpu.activelo import examples as jexamples, plot as jplot  # noqa: E402
from boardlaw_tpu.arena import analysis as jaanalysis, live as jlive, \
    mohex_calibration as jmohex_calibration  # noqa: E402
from boardlaw_tpu.envs import hex as jhex  # noqa: E402
from boardlaw_tpu.pavlov import runs as jruns  # noqa: E402
from boardlaw_tpu_torch import analysis, mohex, sql, train  # noqa: E402
from boardlaw_tpu_torch.activelo import examples, plot  # noqa: E402
from boardlaw_tpu_torch.arena import analysis as aanalysis, mohex_calibration, \
    perfect  # noqa: E402
from boardlaw_tpu_torch.draws import Draws  # noqa: E402
from boardlaw_tpu_torch.envs import hex as thex  # noqa: E402
from boardlaw_tpu_torch.pavlov import storage as pstorage  # noqa: E402
from boardlaw_tpu_torch.pavlov.tests import mock_dir  # noqa: E402
from test_torch_run import TINY  # noqa: E402

torch.set_num_threads(2)

STUB = f"{sys.executable} {os.path.join(os.path.dirname(__file__), 'gtp_stub.py')}"


def _jax_first_valid(world, key, **kwargs):
    return {"actions": jnp.argmax(world.valid, -1).astype(jnp.int32),
            "v": world.seats.astype(jnp.float32)}


def _first_valid(world, draws, **kwargs):
    return {"actions": torch.argmax(world.valid.to(torch.uint8), -1).to(torch.int32),
            "v": world.seats.to(torch.float32)}


@pytest.mark.parametrize("stop", [{"n_steps": 6}, {"n_trajs": 4}, {"n_reps": 1}])
def test_rollout_matches_jax(stop):
    jtrace = janalysis.rollout(jhex.Hex.initial(4, 3), [_jax_first_valid] * 2, **stop)
    trace = analysis.rollout(thex.Hex.initial(4, 3, device="cpu"), [_first_valid] * 2, **stop)
    np.testing.assert_array_equal(trace["actions"].numpy(), np.asarray(jtrace["actions"]))
    np.testing.assert_array_equal(trace["worlds"].board.numpy(),
                                  np.asarray(jtrace["worlds"].board))
    np.testing.assert_array_equal(trace["worlds"].seats.numpy(),
                                  np.asarray(jtrace["worlds"].seats))
    for f in ("terminal", "rewards"):
        np.testing.assert_array_equal(getattr(trace["transitions"], f).numpy(),
                                      np.asarray(getattr(jtrace["transitions"], f)))
    assert set(trace["decisions"]) == set(jtrace["decisions"]) == {"0", "1"}
    for a, d in trace["decisions"].items():
        for k, v in d.items():
            np.testing.assert_array_equal(v, jtrace["decisions"][a][k], err_msg=k)
    assert (trace["decisions"]["0"]["mask"] ^ trace["decisions"]["1"]["mask"]).all()

    if "n_steps" in stop:
        enc = analysis.record_worlds(trace["worlds"], n_envs=2)
        jenc = janalysis.record_worlds(jtrace["worlds"], n_envs=2)
        assert enc.array().shape[0] == 6
        np.testing.assert_array_equal(enc.array(), jenc.array())
    with pytest.raises(ValueError):
        analysis.rollout(thex.Hex.initial(2, 3, device="cpu"), [_first_valid] * 2)


def test_play_out_perfect_black_always_wins():
    solver = perfect.Solver(3, device="cpu")
    agents = [perfect.PerfectAgent(solver, seed=0), perfect.PerfectAgent(solver, seed=1)]
    winners = mohex_calibration.play_out(thex.Hex.initial(8, 3, device="cpu"), agents,
                                         draws=Draws(0, "cpu"))
    assert (winners == 0).all(), winners
    assert mohex_calibration.initial_states is perfect.initial_states


def test_calibrate_against_the_stub_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("BOARDLAW_DB", str(tmp_path / "db.sql"))
    monkeypatch.setattr(mohex, "BINARY", STUB)
    with mock_dir():
        run = train.run(max_steps=1, **TINY)
        pstorage.save_snapshot(run, {"agent": pstorage.load_latest(run)["agent"]},
                               n_samples=8.0, n_flops=1e6)
        sql.refresh()
        aid = int(sql.agent_query().index[0])
        results = mohex_calibration.calibrate(aid, n_envs=4, draws=Draws(0, "cpu"),
                                              device="cpu")
        assert sum(r["games"] for r in results) == 4
        rows = sql.mohex_trial_query()
        assert len(rows) == 2
        assert rows.black_agent[0] == aid and np.isnan(rows.white_agent[0])
        assert np.isnan(rows.black_agent[1]) and rows.white_agent[1] == aid
        cal = mohex_calibration.calibrations(3)
        jcal = jmohex_calibration.calibrations(3)
        assert cal.agent_id.tolist() == [aid] == jcal.agent_id.astype(int).tolist()
        assert cal.winrate[0] == jcal.winrate.iloc[0] and cal.games[0] == 4
        assert mohex_calibration.best_agent(3) == aid


def test_reference_wins_against_the_stub_engine(tmp_path, monkeypatch):
    monkeypatch.setattr(mohex, "BINARY", STUB)
    monkeypatch.setattr(mohex_calibration, "DATA", tmp_path / "mohex.json")
    wins = mohex_calibration.reference_wins(3, device="cpu")
    assert wins.shape == (72,) and set(wins.tolist()) <= {0, 1}
    assert (tmp_path / "mohex.json").exists()
    np.testing.assert_array_equal(mohex_calibration.reference_wins(3, device="cpu"), wins)


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.mu), np.asarray(j.mu), atol=2e-3)
    np.testing.assert_allclose(np.asarray(t.sigmad), np.asarray(j.sigmad), atol=2e-3)
    np.testing.assert_allclose(np.asarray(t.Sigma), np.asarray(j.Sigma), rtol=2e-2)


def test_activelo_examples_match_jax():
    truth, soln = examples.generated_example(8, seed=1, device="cpu")
    jtruth, jsoln = jexamples.generated_example(8, seed=1)
    np.testing.assert_array_equal(truth, jtruth)
    _close(soln, jsoln)
    np.testing.assert_allclose(examples.reuse_example(6, repeats=2, device="cpu"),
                               jexamples.reuse_example(6, repeats=2), atol=2e-3)
    for family in ("linear_ranks", "log_ranks", "pow_ranks", "random_ranks"):
        np.testing.assert_array_equal(getattr(examples, family)(7), getattr(jexamples, family)(7))

    truth, trace = examples.simulate_log_ranks(5, max_rounds=6, device="cpu")
    _, jtrace = jexamples.simulate_log_ranks(5, max_rounds=6)
    assert [r["suggestion"] for r in trace] == [r["suggestion"] for r in jtrace]
    for r, j in zip(trace, jtrace):  # each round warm-starts from the last: gaps add up
        np.testing.assert_allclose(r["mu"], j["mu"], atol=5e-3)
        assert r["games"] == j["games"]

    # the gain matrix is symmetric, so (i, j) and (j, i) tie; each package's
    # roundoff picks one orientation, and the games (and picks) go apart
    # from there: the picks are JAX's up to the first such tie
    soln, picks = plot.example(n_agents=4, n_rounds=8, device="cpu")
    jsoln, jpicks = jplot.example(n_agents=4, n_rounds=8)
    picks = [tuple(int(x) for x in p) for p in picks]
    jpicks = [tuple(int(x) for x in p) for p in jpicks]
    apart = next((k for k, (p, q) in enumerate(zip(picks, jpicks)) if p != q), None)
    if apart is None:
        _close(soln, jsoln)
    else:
        assert picks[apart] == jpicks[apart][::-1]
    # and the JAX test's own checks, at its 20 rounds
    soln, picks = plot.example(n_agents=4, n_rounds=20, device="cpu")
    assert len(picks) == 20 and np.asarray(soln.mu)[0] > np.asarray(soln.mu)[-1]
    assert plot.diagnostics(soln, names=list("abcd")) is not None


def test_arena_analysis_matches_jax():
    with mock_dir():
        run = jruns.new_run(boardsize=3)
        for black, white, bw, ww in (("a", "b", 7, 3), ("b", "a", 4, 6), ("a", "c", 5, 5),
                                     ("c", "b", 6, 2)):
            jlive.record_result(run, black, white, bw, ww)
        soln, jsoln = aanalysis.solution(run, device="cpu"), jaanalysis.solution(run)
        assert soln.names == list(jsoln.mu.index) == ["a", "b", "c"]
        _close(soln, jsoln)
        for a, b in (("a", "b"), ("c", "a")):
            np.testing.assert_allclose(aanalysis.difference(soln, a, b),
                                       jaanalysis.difference(jsoln, a, b), atol=2e-3)
        df, jdf = aanalysis.elos(run, device="cpu"), jaanalysis.elos(run)
        assert list(df.index) == list(jdf.index)
        np.testing.assert_allclose(df.elo, jdf.elo, atol=2e-3)
        np.testing.assert_allclose(df["std"], jdf["std"], rtol=1e-2)  # sqrt of Sigma's 2e-2
        assert aanalysis.errorbars(run, device="cpu") is not None
        assert aanalysis.winrate_heatmap(run) is not None
        assert aanalysis.nontransitivity(run, device="cpu") is not None
