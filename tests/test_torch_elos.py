"""The port's Elo solvers (`elos`, `activelo`) against the JAX package's, on
the CPU, on trials and game matrices made with numpy from a seed.

* `symmetrize` gives the JAX package's frames (NaN where either colour order
  of a pair has no games) from a DataFrame, and the same numbers as numpy
  from the port's `Trials`.
* `elos.solve`: both packages run L-BFGS on a float32 loss, whose roundoff
  moves the point where the optimiser stops along the flat valley of the
  likelihood: the ratings agree to atol 2e-3 natural-log units (0.35 Elo
  points), and `elo_errors` to atol 1e-3.
* `expected_log_sigmoid`, the ELBO and its gradient at one theta: float32
  roundoff (rtol 1e-5, the gradient atol 1e-4 on values of order 10-100).
* `activelo.solve`: mu, the pairwise gaps mu_d and their std sigma_d agree
  to atol 2e-3; Sigma agrees to rtol 2e-2, because its common mode (the
  variance of the ratings' mean, about 25 here) is pinned only by the prior
  and the two float32 L-BFGS paths stop at slightly different points along
  it. The suggested pair is the JAX package's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from boardlaw_tpu import activelo as jactivelo, elos as jelos
from boardlaw_tpu.activelo import solvers as jsolvers
from boardlaw_tpu_torch import activelo, elos
from boardlaw_tpu_torch.activelo import solvers
from boardlaw_tpu_torch.arena.neural import Trials

COLUMNS = ["black_agent", "white_agent", "black_wins", "white_wins"]


def _trials(seed, names="abcd", p=0.85):
    rng = np.random.default_rng(seed)
    rows = [[b, w, float(rng.integers(0, 10)), float(rng.integers(0, 10))]
            for b in names for w in names if b != w and rng.random() < p]
    return pd.DataFrame(rows, columns=COLUMNS)


def _games(seed, N):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 20, (N, N)).astype(float)
    n = n + n.T
    np.fill_diagonal(n, 0)
    return n, np.floor(n * rng.random((N, N)))


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetrize_matches_jax(seed):
    frame = _trials(seed)
    jws, jgs = jelos.symmetrize(frame)
    tws, tgs = elos.symmetrize(frame)
    pd.testing.assert_frame_equal(tws, jws)
    pd.testing.assert_frame_equal(tgs, jgs)
    assert jws.isna().values.any()  # some pairs played one colour order only
    ws, gs, names = elos.symmetrize(Trials(frame.itertuples(index=False)))
    assert names == list(jws.index)
    np.testing.assert_array_equal(ws, jws.values)
    np.testing.assert_array_equal(gs, jgs.values)


@pytest.mark.parametrize("seed", [0, 3])
def test_elo_solve_and_errors_match_jax(seed):
    frame = _trials(seed, p=1.0)
    jr = jelos.solve(*jelos.symmetrize(frame))
    tr = elos.solve(*elos.symmetrize(frame), device="cpu")
    assert tr.name == "elo" and list(tr.index) == list(jr.index)
    np.testing.assert_allclose(tr.values, jr.values, atol=2e-3)
    assert tr.max() == 0
    np.testing.assert_allclose(elos.elo_errors(tr, frame).values,
                               jelos.elo_errors(jr, frame).values, atol=1e-3)
    # numpy with names, as on the card's machine
    ws, gs, names = elos.symmetric_matrices(Trials(frame.itertuples(index=False)))
    r = elos.solve(ws, gs, device="cpu")
    np.testing.assert_array_equal(r, tr.values)
    np.testing.assert_array_equal(elos.elo_errors(r, frame, names),
                                  elos.elo_errors(tr, frame).values)


def test_expected_log_sigmoid_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.normal(0, 3, (5, 5)).astype(np.float32)
    s2 = rng.uniform(0, 9, (5, 5)).astype(np.float32)
    s2[0, 0] = 0.0  # the clamp at 1e-12
    want = np.asarray(jsolvers.expected_log_sigmoid(jnp.asarray(mu), jnp.asarray(s2)))
    got = solvers.expected_log_sigmoid(torch.tensor(mu), torch.tensor(s2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [2, 5])
def test_elbo_and_gradient_match_jax(N):
    n, w = _games(N, N)
    theta = np.random.default_rng(N).normal(0, 0.5, N + N * (N + 1) // 2).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda t: -jsolvers._elbo(t, jnp.asarray(n), jnp.asarray(w), N))(
        jnp.asarray(theta))
    t = torch.tensor(theta, requires_grad=True)
    v = -solvers._elbo(t, torch.tensor(n, dtype=torch.float32),
                       torch.tensor(w, dtype=torch.float32), N)
    (g,) = torch.autograd.grad(v, t)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    # the packing: mu, then the lower triangle row by row, softplus diagonal
    mu, L = solvers._unpack(torch.tensor(theta), N)
    jmu, jL = jsolvers._unpack(jnp.asarray(theta), N)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-6)
    np.testing.assert_array_equal(solvers._pack_init(np.zeros(N), np.eye(N), N),
                                  jsolvers._pack_init(np.zeros(N), np.eye(N), N))


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.mu), np.asarray(j.mu), atol=2e-3)
    np.testing.assert_allclose(np.asarray(t.mud), np.asarray(j.mud), atol=2e-3)
    np.testing.assert_allclose(np.asarray(t.sigmad), np.asarray(j.sigmad), atol=2e-3)
    np.testing.assert_allclose(np.asarray(t.Sigma), np.asarray(j.Sigma), rtol=2e-2)


@pytest.mark.parametrize("N", [3, 4])
def test_activelo_solve_matches_jax(N):
    n, w = _games(N + 10, N)
    js = jactivelo.solve(n, w)
    ts = activelo.solve(n, w, names=list("abcd")[:N], device="cpu")
    _close(ts, js)
    assert ts.μ is ts.mu and ts.Σ is ts.Sigma and ts.σd is ts.sigmad
    # a warm start from the solution
    _close(activelo.solve(n, w, soln=ts, device="cpu"), jactivelo.solve(n, w, soln=js))
    # improvement and the suggested pair: indices without names, names with
    np.testing.assert_allclose(activelo.improvement(ts), jactivelo.improvement(js),
                               rtol=2e-2, atol=1e-4)
    assert activelo.suggest(ts) == tuple("abcd"[i] for i in jactivelo.suggest(js))
    assert activelo.suggest(activelo.solve(n, w, device="cpu")) == jactivelo.suggest(js)


def test_activelo_frames_match_jax():
    idx = ["p", "q", "r"]
    n, w = _games(7, 3)
    nf, wf = pd.DataFrame(n, idx, idx), pd.DataFrame(w, idx, idx)
    js = jactivelo.solve(nf, wf)
    ts = activelo.solve(nf, wf, device="cpu")
    assert isinstance(ts.mu, pd.Series) and isinstance(ts.Sigma, pd.DataFrame)
    assert list(ts.mu.index) == idx and ts.names == idx
    _close(ts, js)
    imp = activelo.improvement(ts)
    assert isinstance(imp, pd.DataFrame)
    assert activelo.suggest(ts) == jactivelo.suggest(js)
