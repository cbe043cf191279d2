"""One self-play actor step of the port against the JAX package's, on the
same worlds, weights and draws. `actor_record` is a closure inside the JAX
package's `make_train`, so the JAX step is composed here as train.py does it:
`mcts`, `root`, `jax.random.categorical`, `Hex.step` and `n_leaves`, jitted
as the JAX actor runs. Sampled actions, new worlds and the record's
integer/bool fields are equal; its float fields agree to atol 1e-5 (stored
as bf16 where the record stores them so)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from boardlaw_tpu import learning as jlearning
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu_torch import learning, train
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import search as TS
from boardlaw_tpu_torch.models import convert

torch.set_num_threads(2)


class JaxDraws(Draws):
    """Draws of one JAX actor step from its key: split into the search key
    and the action key, the search key into the Dirichlet and pass keys."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        k_search, self.k_act = jax.random.split(key)
        k_init, self.k_sims = jax.random.split(k_search)
        self.k_n, self.k_u, self.k_b = jax.random.split(k_init, 3)

    def dirichlet(self, shape, rounds):
        shape = tuple(shape)
        return (torch.tensor(np.asarray(jax.random.normal(self.k_n, (rounds,) + shape))),
                torch.tensor(np.asarray(jax.random.uniform(self.k_u, (rounds,) + shape, minval=1e-20))),
                torch.tensor(np.asarray(jax.random.uniform(self.k_b, shape, minval=1e-20))))

    def pass_rands(self, p, shape):
        k_rand, _ = jax.random.split(jax.random.fold_in(self.k_sims, p))
        return torch.tensor(np.asarray(jax.random.uniform(k_rand, tuple(shape))))

    def gumbel(self, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(self.k_act, tuple(shape))))


class JaxMixDraws(Draws):
    """The key chain of the JAX package's `learning.mix`."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        self.key = key

    def gumbel(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.gumbel(sub, tuple(shape))))


def _t(x):
    return torch.tensor(np.asarray(x))


def test_categorical_is_argmax_of_gumbel():
    # the seam's premise: jax.random.categorical == argmax(logits + gumbel)
    key = jax.random.PRNGKey(4)
    logits = jnp.where(jax.random.uniform(jax.random.PRNGKey(5), (64, 25)) < 0.3, -jnp.inf,
                       jax.random.normal(jax.random.PRNGKey(6), (64, 25)))
    want = np.asarray(jax.random.categorical(key, logits, axis=-1))
    got = np.asarray(jnp.argmax(logits + jax.random.gumbel(key, logits.shape), -1))
    np.testing.assert_array_equal(got, want)


def test_mix_matches_jax():
    key = jax.random.PRNGKey(3)
    jw = jlearning.mix(jhex.Hex.initial(16, 5), key, T=30)
    tw = learning.mix(thex.Hex.initial(16, 5, device="cpu"), JaxMixDraws(key), T=30)
    np.testing.assert_array_equal(tw.board.numpy(), np.asarray(jw.board))
    np.testing.assert_array_equal(tw.seats.numpy(), np.asarray(jw.seats))


def test_actor_record_matches_jax():
    cfg = train.TrainConfig(boardsize=5, width=16, depth=2, n_envs=8, n_nodes=13,
                            leaves_per_pass=4, mix_steps=9)
    world1 = jhex.Hex.initial(1, cfg.boardsize)
    jmodel = JFCModel(world1.obs_space, world1.action_space, width=cfg.width, depth=cfg.depth)
    params = jmodel.init(jax.random.PRNGKey(0), world1.obs, world1.valid, world1.seats)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, params)
    jcfg = S.MCTSConfig(n_nodes=cfg.n_nodes, c_puct=cfg.c_puct, noise_eps=cfg.noise_eps,
                        leaves_per_pass=cfg.leaves_per_pass, use_pallas=False, grow_passes=True,
                        pallas_walk=False, sample_cum="shift")

    def eval_fn(world, key=None):
        return jmodel.apply(params, world.obs, world.valid, world.seats)

    @jax.jit
    def jax_actor(worlds, key):
        k_search, k_act = jax.random.split(key)
        tree = S.mcts(worlds, eval_fn, k_search, jcfg)
        r = S.root(tree)
        actions = jax.random.categorical(k_act, r["logits"], axis=-1)
        new_worlds, transition = worlds.step(actions)
        record = {
            "logits": r["logits"].astype(jnp.bfloat16),
            "prior": r["prior"].astype(jnp.bfloat16),
            "v": r["v"],
            "n_leaves": S.n_leaves(tree).astype(jnp.int32),
            "terminal": transition.terminal,
            "rewards": transition.rewards,
        }
        return new_worlds, record, actions

    jworlds = jlearning.mix(jhex.Hex.initial(cfg.n_envs, cfg.boardsize), jax.random.PRNGKey(1),
                            cfg.mix_steps)
    key = jax.random.PRNGKey(2)
    jnew, jrec, jact = jax_actor(jworlds, key)

    model = train.build_model(cfg, device="cpu")
    model.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    tworlds = thex.Hex(board=_t(jworlds.board), seats=_t(jworlds.seats))
    actor = train.make_actor(cfg, model)
    tnew, trec = actor(tworlds, JaxDraws(key))
    # the same step again, keeping its tree to read the sampled actions
    draws = JaxDraws(key)
    again, _, ttree = train.actor_record(cfg, model, tworlds, draws, return_tree=True)
    assert torch.equal(again.board, tnew.board)
    logits = TS.root(ttree)["logits"]
    tact = torch.argmax(logits + draws.gumbel(logits.shape), -1)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))

    np.testing.assert_array_equal(tnew.board.numpy(), np.asarray(jnew.board))
    np.testing.assert_array_equal(tnew.seats.numpy(), np.asarray(jnew.seats))
    assert trec["worlds"] is tworlds
    for k in ("n_leaves", "terminal"):
        np.testing.assert_array_equal(trec[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    for k in ("rewards", "v"):
        np.testing.assert_allclose(trec[k].numpy(), np.asarray(jrec[k]), atol=1e-5, err_msg=k)
    for k in ("logits", "prior"):
        assert trec[k].dtype == torch.bfloat16
        t, j = trec[k].float().numpy(), np.asarray(jrec[k], np.float32)
        np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
        fin = np.isfinite(j)
        # bf16 keeps 8 bits: equal up to one bf16 step of the stored value
        np.testing.assert_allclose(t[fin], j[fin], rtol=2 ** -7, atol=1e-5, err_msg=k)
