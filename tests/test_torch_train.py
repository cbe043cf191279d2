"""The port's learner step against the JAX package's.

The JAX package's `make_train` at boardsize 3 (K=1, `run`'s rule), width 16,
depth 2, 8 envs, 8 nodes, `buffer_len=4`, `mix_steps=16` runs `init` and
`warmup`; `models.convert.train_state_from_jax` carries that state into the
port; then each package takes one `train_step`, the port with the JAX key
chain injected through its `Draws` seam.

* The pushed record, the new worlds, `ptr` and `step` are equal (the
  record's floats to atol 1e-5, its bf16 logits to one bf16 step).
* Every `aux` entry agrees to rtol 1e-4 / atol 1e-6. At the first learner
  step Adam's bias-corrected moments give v = m^2 up to roundoff, so
  `noise-scale` is roundoff-sized (~6e-6 here) in both packages and is held
  by the atol; tests/test_torch_learning.py holds `noise_scale` against the
  JAX function on multi-step Adam states.
* Gradients agree to atol 1e-6 / rtol 1e-4. The JAX gradient is read back
  from optax's first moment after the step (mu = 0.1 g from mu = 0).
* Updated parameters agree to atol 1e-6 wherever the JAX gradient exceeds
  1e-6 in magnitude, and to atol lr elsewhere: Adam's first step is about
  lr*sign(g), and where |g| is near eps = 1e-8 a roundoff difference in g
  moves the step by up to lr.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from boardlaw_tpu import train as jtrain
from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.models import convert
from test_torch_actor import JaxDraws

torch.set_num_threads(2)


class JaxTrainDraws(JaxDraws):
    """The draws of one JAX `train_step` from its state key:
    `key, k_actor, k_sample = split(state.key, 3)`."""

    def __init__(self, state_key, n_sims):
        _, k_actor, self.k_sample = jax.random.split(state_key, 3)
        super().__init__(k_actor, n_sims)

    def slots(self, B, T):
        return torch.tensor(np.asarray(jax.random.randint(self.k_sample, (B,), 0, T)))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def test_train_step_matches_jax():
    kw = dict(n_envs=8, buffer_len=4, mix_steps=16)
    jcfg = jtrain.TrainConfig(boardsize=3, width=16, depth=2, n_nodes=8, **kw)
    tcfg = train.make_config(3, 16, 2, nodes=8, **kw)
    assert tcfg.leaves_per_pass == jcfg.leaves_per_pass == 1
    _, _, init, warmup, train_step = jtrain.make_train(jcfg)
    jstate = warmup(init(jax.random.PRNGKey(5)))
    # non-zero ReZero gates, so the residual blocks count in the step
    rng = np.random.default_rng(5)
    jstate = jstate.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, jstate.params))
    before = _np(jstate)

    tstate = convert.train_state_from_jax(before, tcfg, device="cpu")
    assert (tstate.ptr, tstate.step) == (int(before.ptr), 0)
    jnew, jaux = train_step(jstate)
    jnew, jaux = _np(jnew), _np(jaux)
    tnew, taux = train.train_step(tcfg, tstate, JaxTrainDraws(jnp.asarray(before.key), 7))

    assert (tnew.ptr, tnew.step) == (int(jnew.ptr), int(jnew.step)) == ((before.ptr + 1) % 4, 1)
    np.testing.assert_array_equal(tnew.worlds.board.numpy(), jnew.worlds.board)
    np.testing.assert_array_equal(tnew.worlds.seats.numpy(), jnew.worlds.seats)
    slot = int(before.ptr)
    for name in ("board", "seats"):
        np.testing.assert_array_equal(getattr(tnew.buffer["worlds"], name)[slot].numpy(),
                                      getattr(jnew.buffer["worlds"], name)[slot])
    for k in ("n_leaves", "terminal"):
        np.testing.assert_array_equal(tnew.buffer[k][slot].numpy(), jnew.buffer[k][slot], err_msg=k)
    for k in ("v", "rewards"):
        np.testing.assert_allclose(tnew.buffer[k][slot].numpy(), jnew.buffer[k][slot], atol=1e-5)
    for k in ("logits", "prior"):
        t = tnew.buffer[k][slot].float().numpy()
        j = np.asarray(jnew.buffer[k][slot], np.float32)
        np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=2 ** -7, atol=1e-5, err_msg=k)

    assert set(taux) == set(jaux)
    for k in sorted(jaux):
        assert torch.isfinite(torch.as_tensor(taux[k])).all(), k
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    adam = jnew.opt_state[0]
    assert int(adam.count) == 1
    jgrads = {k: v / 0.1 for k, v in convert.from_flax(adam.mu).items()}
    jparams = convert.from_flax(jnew.params)
    lr = tcfg.lr
    for name, p in tnew.model.named_parameters():
        g, want = jgrads[name].reshape(p.shape), jparams[name].reshape(p.shape)
        assert torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-6, msg=name)
        big = g.abs() > 1e-6
        torch.testing.assert_close(p.detach()[big], want[big], rtol=0, atol=1e-6, msg=name)
        torch.testing.assert_close(p.detach()[~big], want[~big], rtol=0, atol=lr, msg=name)


def test_make_config_applies_run_rule():
    c9 = train.make_config(9, 512, 4)
    assert (c9.leaves_per_pass, c9.grow_passes, c9.n_envs, c9.n_nodes) == (8, True, 32768, 64)
    assert c9.mcts_config().n_passes == 8
    c6 = train.best_config(6)
    assert (c6.width, c6.depth, c6.n_nodes, c6.c_puct) == (128, 1, 64, 1 / 16)
    assert (c6.leaves_per_pass, c6.grow_passes) == (1, False)
    # an explicit K=1 at 9x9 stays sequential, as in `run`
    assert not train.make_config(9, 512, 4, leaves_per_pass=1).grow_passes
    for b, row in jtrain.BEST.set_index("boardsize").iterrows():
        cfg = train.best_config(int(b))
        assert (cfg.width, cfg.depth, cfg.n_nodes, cfg.c_puct) == (
            int(row.width), int(row.depth), int(row.nodes), float(row.c_puct))


def test_make_train_runs_on_cpu():
    cfg = train.make_config(3, 8, 1, nodes=6, n_envs=4, buffer_len=3, mix_steps=5)
    model, opt, init, warmup, train_step = train.make_train(cfg, device="cpu")
    draws = Draws(1, "cpu")
    state = warmup(init(draws), draws)
    assert state.ptr == 0 and state.step == 0 and state.model is not model
    assert (state.buffer["n_leaves"] > 0).all()  # every slot was written
    before = [p.detach().clone() for p in state.model.parameters()]
    for i in range(2):
        state, aux = train_step(state, draws)
        assert state.step == i + 1 and state.ptr == i + 1
        assert all(torch.isfinite(v).all() for v in aux.values())
    assert any(not torch.equal(b, p) for b, p in zip(before, state.model.parameters()))
    # the initial model is left as it was
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  train.make_train(cfg, device="cpu")[0].parameters()))
