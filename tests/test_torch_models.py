"""The port's FCModel, fed the JAX package's flax weights through
`models.convert.from_flax`, against `model.apply`: logits and v agree to
rtol/atol 1e-5 in float32 (the products are summed in another order), and
the -inf pattern of the logits is identical."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.models import convert, heads
from boardlaw_tpu_torch.models.networks import FCModel, make_eval_fn

torch.set_num_threads(2)


def _flax_model(boardsize=5, width=16, depth=2, seed=0):
    world = jhex.Hex.initial(1, boardsize)
    model = JFCModel(world.obs_space, world.action_space, width=width, depth=depth)
    params = model.init(jax.random.PRNGKey(seed), world.obs, world.valid, world.seats)
    # ReZero alphas start at 0; make them non-zero so the residual paths count
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, params)
    return model, jax.tree.map(np.asarray, params)


def _random_worlds(boardsize, n_envs, n_plies, seed):
    rng = np.random.default_rng(seed)
    world = jhex.Hex.initial(n_envs, boardsize)
    step = jax.jit(lambda w, a: w.step(a))
    for _ in range(n_plies):
        valid = np.asarray(world.valid)
        a = np.array([rng.choice(np.flatnonzero(v)) for v in valid], np.int32)
        world, _ = step(world, jnp.asarray(a))
    return world


def _port_model(params, boardsize, width, depth):
    space = thex.Hex.initial(1, boardsize, device="cpu")
    model = FCModel(space.obs_space, space.action_space, width=width, depth=depth, device="cpu")
    model.load_state_dict(convert.from_flax(params))
    return model


@pytest.mark.parametrize("boardsize,width,depth", [(5, 16, 2), (9, 32, 3)])
def test_fcmodel_matches_flax(boardsize, width, depth):
    jmodel, params = _flax_model(boardsize, width, depth)
    jworld = _random_worlds(boardsize, n_envs=32, n_plies=2 * boardsize, seed=boardsize)
    jout = jmodel.apply(params, jworld.obs, jworld.valid, jworld.seats)

    model = _port_model(params, boardsize, width, depth)
    tworld = thex.Hex(board=torch.tensor(np.asarray(jworld.board)),
                      seats=torch.tensor(np.asarray(jworld.seats)))
    tout = make_eval_fn(model)(tworld)

    jl, tl = np.asarray(jout["logits"]), tout["logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    assert np.isneginf(jl).any()
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout["v"].numpy(), np.asarray(jout["v"]), rtol=1e-5, atol=1e-5)


def test_convert_layout():
    _, params = _flax_model(5, 16, 2)
    sd = convert.from_flax(params)
    p = params["params"]
    assert sd["intake.dense.weight"].shape == (16, 50)
    np.testing.assert_array_equal(sd["intake.dense.weight"].numpy(), p["intake"]["Dense_0"]["kernel"].T)
    assert float(sd["blocks.1.alpha"]) == float(p["block_1"]["alpha"]) != 0.0
    assert sd["policy.dense.weight"].shape == (25, 16)
    assert sd["value.dense.weight"].shape == (1, 16)


def test_scatter_values_and_init():
    v = torch.tensor([0.5, -0.25, 1.0])
    seats = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert heads.scatter_values(v, seats).tolist() == [[0.5, -0.5], [0.25, -0.25], [-1.0, 1.0]]

    space = thex.Hex.initial(1, 5, device="cpu")
    g = torch.Generator().manual_seed(3)
    model = FCModel(space.obs_space, space.action_space, width=16, depth=2, device="cpu", generator=g)
    w = model.blocks[0].dense.weight.detach()
    # orthogonal with gain sqrt(2): W W^T = 2 I
    np.testing.assert_allclose((w @ w.T).numpy(), 2 * np.eye(16), atol=1e-5)
    assert model.blocks[0].alpha.item() == 0.0
    g2 = torch.Generator().manual_seed(3)
    again = FCModel(space.obs_space, space.action_space, width=16, depth=2, device="cpu", generator=g2)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
