"""The port's space-driven heads (boardlaw_tpu_torch/models/heads.py) against
the JAX package's flax modules, fed the flax parameters through
`models.convert.from_flax`, at float32 and bfloat16 compute.

* Every intake (`intake_module` over Tensor, Vector, Empty and a dict of all
  three, whose `ConcatIntake` concatenates in the dict's order) gives the
  flax module's output bit for bit at both dtypes: a product of bf16 inputs
  and weights is rounded to bf16 once, then the bias is added and rounded,
  on both sides.
* The policy heads (`output_module` over Masked and Discrete) agree to atol
  4e-6 with the same -inf pattern, and the value head (`ValueOutput`, one
  seat and two) to atol 5e-7: the float32 softmax and tanh after the bf16
  product are other code than XLA's. Both tolerances are 4x the largest
  difference measured over six seeds (9.5e-7 and 1.2e-7).
* `from_flax` maps each flax layout onto the port's names, with float32
  parameters under either compute dtype.

The flax biases start at zero; the cases add noise to every parameter so
that the biases count.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from boardlaw_tpu.envs import base as jbase
from boardlaw_tpu.models import heads as jheads
from boardlaw_tpu_torch.envs import base as tbase
from boardlaw_tpu_torch.models import convert, heads

torch.set_num_threads(2)

WIDTH, B = 32, 16
DTYPES = ["float32", "bfloat16"]


def _spaces(lib):
    return {"tensor": lib.Tensor((5, 5, 2)), "vector": lib.Vector(7), "empty": lib.Empty(),
            "concat": {"z": lib.Tensor((5, 5, 2)), "a": lib.Vector(7), "e": lib.Empty()}}


def _obs(space, rng):
    if isinstance(space, dict):
        return {k: _obs(v, rng) for k, v in space.items()}
    if type(space).__name__ == "Empty":
        return np.zeros((B, 0), np.float32)
    return rng.normal(0, 1, (B,) + tuple(np.atleast_1d(space.dim))).astype(np.float32)


def _torch(x):
    return {k: _torch(v) for k, v in x.items()} if isinstance(x, dict) else torch.tensor(x)


def _noised(params, rng):
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(np.float32),
                        params)


def _port(name, module, flax_params):
    """`module` under the model's attribute `name`, loaded through from_flax."""
    holder = nn.Module()
    setattr(holder, name, module)
    holder.load_state_dict(convert.from_flax({name: flax_params["params"]}))
    return module


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["tensor", "vector", "empty", "concat"])
def test_intakes_match_flax(kind, dtype):
    rng = np.random.default_rng(len(kind))
    jspace, tspace = _spaces(jbase)[kind], _spaces(tbase)[kind]
    obs = _obs(jspace, rng)
    jmod = jheads.intake_module(jspace, WIDTH, jnp.dtype(dtype))
    params = _noised(jmod.init(jax.random.PRNGKey(len(kind)), obs), rng)
    want = np.asarray(jmod.apply(params, obs).astype(jnp.float32))

    tmod = _port("intake", heads.intake_module(tspace, WIDTH, getattr(torch, dtype)), params)
    got = tmod(_torch(obs))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, WIDTH)
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    assert all(p.dtype == torch.float32 for p in tmod.parameters())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["Masked", "Discrete"])
def test_policy_outputs_match_flax(kind, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, WIDTH)).astype(np.float32)
    valid = rng.random((B, 25)) < 0.7
    valid[:, 0] = True
    jmod = jheads.output_module(getattr(jbase, kind)(25), WIDTH, jnp.dtype(dtype))
    xin = jnp.asarray(x).astype(jnp.dtype(dtype))
    params = _noised(jmod.init(jax.random.PRNGKey(3), xin, valid), rng)
    want = np.asarray(jmod.apply(params, xin, valid))

    tmod = _port("policy", heads.output_module(getattr(tbase, kind)(25), WIDTH,
                                               getattr(torch, dtype)), params)
    got = tmod(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(valid)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want).any() == (kind == "Masked")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=4e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_seats", [1, 2])
def test_value_output_matches_flax(n_seats, dtype):
    rng = np.random.default_rng(n_seats)
    x = rng.normal(0, 1, (B, WIDTH)).astype(np.float32)
    seats = rng.integers(0, 2, B).astype(np.int32)
    jmod = jheads.ValueOutput(WIDTH, n_seats, jnp.dtype(dtype))
    xin = jnp.asarray(x).astype(jnp.dtype(dtype))
    params = _noised(jmod.init(jax.random.PRNGKey(n_seats), xin, None, seats), rng)
    want = np.asarray(jmod.apply(params, xin, None, seats))

    tmod = _port("value", heads.ValueOutput(WIDTH, n_seats, getattr(torch, dtype)), params)
    got = tmod(torch.tensor(x).to(getattr(torch, dtype)), None, torch.tensor(seats))
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, n_seats)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=5e-7)


def test_from_flax_layouts():
    rng = np.random.default_rng(0)
    obs = _obs(_spaces(jbase)["concat"], rng)
    jmod = jheads.intake_module(_spaces(jbase)["concat"], WIDTH, jnp.bfloat16)
    p = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), obs))["params"]
    sd = convert.from_flax({"intake": p})
    assert set(sd) == {"intake.intakes.z.dense.weight", "intake.intakes.z.dense.bias",
                       "intake.intakes.a.dense.weight", "intake.intakes.a.dense.bias",
                       "intake.intakes.e.bias", "intake.dense.weight", "intake.dense.bias"}
    assert all(v.dtype == torch.float32 for v in sd.values())
    np.testing.assert_array_equal(sd["intake.dense.weight"].numpy(), p["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["intake.intakes.e.bias"].numpy(), p["intake_e"]["bias"])
    assert sd["intake.dense.weight"].shape == (WIDTH, 3 * WIDTH)
    # the port's module names are the state dict's
    tmod = heads.intake_module(_spaces(tbase)["concat"], WIDTH, torch.bfloat16)
    assert {f"intake.{k}" for k in tmod.state_dict()} == set(sd)


def test_factories_refuse_unknown_spaces():
    with pytest.raises(ValueError):
        heads.intake_module(tbase.Masked(3), WIDTH)
    with pytest.raises(ValueError):
        heads.output_module(tbase.Tensor((3,)), WIDTH)
