"""The port's gradient noise-scale study (`noisescales`) against the JAX
package's, on the CPU.

* `flat_gradient_stats` of one (K, P) gradient matrix made with numpy
  equals JAX's to rtol 1e-6 (both float32; the sums run in another order),
  and `gradient_stats` gives `tests/test_sql_scaling.py`'s zero-variance and
  cancelling-mean cases.
* `gradients` of one fed chunk (numpy worlds, search targets and returns)
  through the JAX package's flax net and the port's FCModel on the
  converted weights, TF32 off: the (T, n_params) policy, value and joint
  matrices agree to rtol 1e-4 and atol 1e-6, column for column (the JAX
  leaf order); `measure`'s statistics over slices of one batch to rtol
  1e-4.
* The offline study end to end at `test_noise_scale_study`'s toy scale on
  the CPU (3x3, a port run of 8 envs): the three rows, no duplicate rows on
  a second call, a `sweep`, `load`'s join, and `NoiseScales` logging
  through pavlov
  (the JAX package's hook logs its silent channels in a form its own stats
  refuse inside a run; that refusal is pinned).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu import noisescales as jnoisescales
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu.pavlov import stats as jstats
from boardlaw_tpu_torch import noisescales, sql, train
from boardlaw_tpu_torch.models import convert
from boardlaw_tpu_torch.pavlov import runs, stats, storage as pstorage
from boardlaw_tpu_torch.pavlov.tests import mock_dir
from test_torch_models import _port_model, _random_worlds

torch.set_num_threads(2)


@pytest.mark.parametrize("K,P", [(8, 1000), (16, 4097)])
def test_flat_gradient_stats_match_jax(K, P):
    rng = np.random.default_rng(K)
    G = (rng.normal(size=(K, P)) * rng.uniform(0.1, 2, size=P) + rng.normal(size=P)) \
        .astype(np.float32)
    got = noisescales.flat_gradient_stats(torch.tensor(G))
    want = jnoisescales.flat_gradient_stats(jnp.asarray(G))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert noisescales.noise_scale(got, 32) == pytest.approx(jnoisescales.noise_scale(want, 32),
                                                             rel=2e-6)


def test_gradient_stats_cases():
    stats_ = noisescales.gradient_stats(lambda b: {"w": torch.ones(4) * b * 0 + 1.0}, [1, 2, 3])
    assert stats_["variance"] == 0 and noisescales.noise_scale(stats_, 32) == 0
    stats_ = noisescales.gradient_stats(
        lambda b: {"w": torch.ones(4) * (1.0 if b % 2 else -1.0), "b": [torch.zeros(2)]},
        [0, 1, 2, 3])
    assert stats_["variance"] > 0 and stats_["mean_sq"] == 0 and stats_["n_params"] == 6


def _chunk(boardsize, T, B, seed):
    """A fed chunk: (T, B) worlds some random plies in, search-target
    log-probs over the valid actions and value targets, as numpy."""
    rng = np.random.default_rng(seed)
    worlds = [_random_worlds(boardsize, B, t % 4, seed + t) for t in range(T)]
    valid = np.stack([np.asarray(w.valid) for w in worlds])
    raw = rng.normal(size=valid.shape).astype(np.float32)
    logits = np.where(valid, raw, -np.inf)
    logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return {
        "obs": np.stack([np.asarray(w.obs) for w in worlds]),
        "valid": valid,
        "seats": np.stack([np.asarray(w.seats) for w in worlds]),
        "logits": logits.astype(np.float32),
        "reward_to_go": rng.uniform(-1, 1, size=(T, B, 2)).astype(np.float32),
    }


def test_gradients_match_jax():
    boardsize, width, depth = 5, 16, 2
    world = jhex.Hex.initial(1, boardsize)
    jmodel = JFCModel(world.obs_space, world.action_space, width=width, depth=depth)
    params = jmodel.init(jax.random.PRNGKey(0), world.obs, world.valid, world.seats)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, params)
    chunk = _chunk(boardsize, T=4, B=8, seed=2)
    want = jnoisescales.gradients(jmodel, params, jax.tree.map(jnp.asarray, chunk))

    model = _port_model(jax.tree.map(np.asarray, params), boardsize, width, depth)
    got = noisescales.gradients(model, {k: torch.tensor(v) for k, v in chunk.items()})
    n_params = sum(x.size for x in jax.tree.leaves(params))
    for kind in noisescales.KINDS:
        assert got[kind].shape == (4, n_params)
        np.testing.assert_allclose(got[kind].numpy(), np.asarray(want[kind]), rtol=1e-4,
                                   atol=1e-6, err_msg=kind)
    assert [n for n, _, _ in convert.flax_order(model)][:3] == \
        ["blocks.0.dense.bias", "blocks.0.dense.weight", "blocks.0.alpha"]

    # `measure`: one timestep's batch in 4 slices, the policy loss
    batch = {k: v[1] for k, v in chunk.items()}
    got = noisescales.measure(model, {k: torch.tensor(v) for k, v in batch.items()},
                              lambda m, b: noisescales._chunk_losses(m, b)[0], n_slices=4)
    want = jnoisescales.measure(jmodel, params, jax.tree.map(jnp.asarray, batch),
                                lambda p, b: jnoisescales._chunk_losses(jmodel, p, b)[0],
                                n_slices=4)
    assert set(got) == set(want) and got["batch_size"] == want["batch_size"] == 2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_noise_scale_study(tmp_path, monkeypatch):
    monkeypatch.setenv("BOARDLAW_DB", str(tmp_path / "db.sql"))
    with mock_dir():
        run = train.run(boardsize=3, width=4, depth=1, n_envs=8, nodes=4, mix_steps=8,
                        buffer_len=4, max_steps=2, storer="time", device="cpu")
        sd = pstorage.load_latest(run)
        pstorage.save_snapshot(run, {"agent": sd["agent"]}, n_samples=16.0, n_flops=1e6)
        sql.refresh()
        idx = int(sql.query("select * from snaps where run == ?", run).idx[0])

        aid = noisescales.evaluate(run, idx, nodes=4, c_puct=1 / 16, perf=False, n_envs=16,
                                   chunk_len=8, device="cpu")
        rows = sql.query("select * from noise_scales where agent_id == ?", aid)
        assert set(rows.kind) == {"policy", "value", "joint"}
        model = train.build_model(train.make_config(3, 4, 1), device="cpu")
        assert (rows.n_params == sum(p.numel() for p in model.parameters())).all()
        assert (rows.batches == 8).all() and (rows.batch_size == 16).all()
        assert np.isfinite(rows.variance).all()

        # idempotent: a second call adds no rows
        noisescales.evaluate_noise_scale(aid, n_envs=16, chunk_len=8, device="cpu")
        assert len(sql.query("select * from noise_scales where agent_id == ?", aid)) == 3

        # a sweep over the snapshot registers and measures one agent a setting
        done = noisescales.sweep(run, idxs=[idx], nodes=[2, 4], cs=[1 / 16], n_envs=8,
                                 device="cpu")
        assert done[1] == aid and done[0] != aid
        assert len(sql.query("select * from noise_scales")) == 6

        df = noisescales.load()
        assert {"policy", "value", "joint"} <= set(df.columns)
        assert np.isfinite(df.loc[aid, "policy"])

        # in training: the components and scales go to the run's stats
        model, chunk = noisescales.collect(aid, n_envs=8, chunk_len=4, device="cpu")
        hook = noisescales.NoiseScales(model, buffer_len=2)
        with stats.to_run(runs.resolve(run)):
            for _ in range(3):
                hook.step(chunk)
        assert {"noise.policy", "noise.variance.joint"} <= set(stats.channels(run))
        assert stats.rows(run, "noise.batches.value")["x"].tolist() == [4.0, 4.0]

        # the JAX package's hook hands the silent kind its value by position,
        # which its stats refuse inside a run
        with jstats.to_run(runs.resolve(run)), pytest.raises(TypeError):
            jstats.silent("noise.mean_sq.policy", 1.0)
