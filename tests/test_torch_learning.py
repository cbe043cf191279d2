"""The port's `learning` against the JAX package's: ports of
tests/test_train.py's return-target and entropy cases, `present_value` /
`reward_to_go` on (T,B,S) inputs, and `noise_scale` read from a torch Adam
that `models.convert.adam_from_optax` filled from an optax adam state."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from boardlaw_tpu import learning as jlearning
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu_torch import learning, train
from boardlaw_tpu_torch.models import convert

torch.set_num_threads(2)


def test_reward_to_go():
    reward = torch.tensor([1.0, 2.0, 3.0])
    value = torch.tensor([4.0, 5.0, 6.0])
    terminal = torch.tensor([False, False, False])
    np.testing.assert_allclose(learning.reward_to_go(reward, value, terminal).numpy(), [9.0, 8.0, 6.0])
    terminal = torch.tensor([False, True, False])
    np.testing.assert_allclose(learning.reward_to_go(reward, value, terminal).numpy(), [3.0, 2.0, 6.0])


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_returns_batched_match_jax(gamma):
    # (T, B, S) shapes as the train step uses them
    rng = np.random.default_rng(0)
    T, B, S = 7, 5, 2
    reward = rng.normal(size=(T, B, S)).astype(np.float32)
    value = rng.normal(size=(T, B, S)).astype(np.float32)
    terminal = np.broadcast_to((rng.random((T, B)) < 0.3)[..., None], (T, B, S))
    want = jlearning.reward_to_go(jnp.asarray(reward), jnp.asarray(value), jnp.asarray(terminal),
                                  gamma)
    got = learning.reward_to_go(torch.tensor(reward), torch.tensor(value),
                                torch.tensor(terminal.copy()), gamma)
    assert got.shape == (T, B, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the last row is the bootstrap (or the terminal reward)
    np.testing.assert_array_equal(got[-1].numpy(), np.where(terminal[-1], reward[-1], value[-1]))

    deltas = rng.normal(size=(T - 1, B, S)).astype(np.float32)
    want = jlearning.present_value(jnp.asarray(deltas), jnp.asarray(value), jnp.asarray(terminal),
                                   gamma)
    got = learning.present_value(torch.tensor(deltas), torch.tensor(value),
                                 torch.tensor(terminal.copy()), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rel_entropy_uniform():
    ent, log_n = learning.rel_entropy(torch.log(torch.full((4, 8), 1 / 8)))
    np.testing.assert_allclose(float(ent), np.log(8), rtol=1e-5)
    np.testing.assert_allclose(float(log_n), np.log(8), rtol=1e-5)


def test_rel_entropy_masked_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 9)).astype(np.float32)
    logits = np.where(rng.random((6, 9)) < 0.3, -np.inf, logits).astype(np.float32)
    logits[:, 0] = 0.0
    want = jlearning.rel_entropy(jax.nn.log_softmax(jnp.asarray(logits)))
    got = learning.rel_entropy(torch.log_softmax(torch.tensor(logits), -1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("steps", [2, 5])
def test_noise_scale_from_converted_optax_state(steps):
    world = jhex.Hex.initial(1, 3)
    jmodel = JFCModel(world.obs_space, world.action_space, width=8, depth=2)
    params = jmodel.init(jax.random.PRNGKey(0), world.obs, world.valid, world.seats)
    opt = optax.adam(1e-3)
    state = opt.init(params)
    for i in range(steps):  # random "gradients", so the moments carry real spread
        grads = jax.tree.map(lambda x, i=i: jax.random.normal(jax.random.PRNGKey(i), x.shape), params)
        _, state = opt.update(grads, state, params)
    want = float(jlearning.noise_scale(64, state))

    cfg = train.TrainConfig(boardsize=3, width=8, depth=2)
    model = train.build_model(cfg, device="cpu")
    model.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    optimizer = convert.adam_from_optax(jax.tree.map(np.asarray, state), model,
                                        train.make_optimizer(cfg, model.parameters()))
    assert float(optimizer.state[model.intake.dense.weight]["step"]) == steps
    np.testing.assert_allclose(float(learning.noise_scale(64, optimizer)), want, rtol=1e-4)
    # before any step there is no Adam state to read
    fresh = train.make_optimizer(cfg, model.parameters())
    assert np.isnan(float(learning.noise_scale(64, fresh)))
