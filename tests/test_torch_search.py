"""The port's whole grow-pass search against the JAX package's, on 5x5 with
B=8, n_nodes=13, K=4: the same converted FCModel on both sides and JAX's
draws injected through the port's `Draws` seam. The JAX side samples with
`sample_cum='shift'` and the XLA walk.

Topology and visit counts (`children`, `parents`, `n`, `n_edge`) and the
leaf worlds are bit-equal; value sums, net values and cumulative rewards
agree to atol 1e-5 (float32 sums taken in another order), and so does
`root()`'s policy.

Both JAX calls are jitted, as the JAX actor runs them. The root solve is
ill-conditioned where one action holds most of the mass: JAX's own eager and
jitted `root()` differ by ~1e-3 in log-probability on one and the same tree,
while the port agrees with the jitted one to ~1e-6.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu.models.networks import FCModel as JFCModel, make_eval_fn as jmake_eval_fn
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.mcts import kernels, search as TS
from boardlaw_tpu_torch.models import convert
from boardlaw_tpu_torch.models.networks import FCModel, make_eval_fn

torch.set_num_threads(2)


class JaxDraws(Draws):
    """The port's draws, taken from the JAX package's key tree for
    `mcts(world, eval_fn, key, cfg)`."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        k_init, self.k_sims = jax.random.split(key)
        self.k_n, self.k_u, self.k_b = jax.random.split(k_init, 3)

    def dirichlet(self, shape, rounds):
        shape = tuple(shape)
        return (torch.tensor(np.asarray(jax.random.normal(self.k_n, (rounds,) + shape))),
                torch.tensor(np.asarray(jax.random.uniform(self.k_u, (rounds,) + shape, minval=1e-20))),
                torch.tensor(np.asarray(jax.random.uniform(self.k_b, shape, minval=1e-20))))

    def pass_rands(self, p, shape):
        k_rand, _ = jax.random.split(jax.random.fold_in(self.k_sims, p))
        return torch.tensor(np.asarray(jax.random.uniform(k_rand, tuple(shape))))


def _models(boardsize=5, width=16, depth=2, seed=0):
    world = jhex.Hex.initial(1, boardsize)
    jmodel = JFCModel(world.obs_space, world.action_space, width=width, depth=depth)
    params = jmodel.init(jax.random.PRNGKey(seed), world.obs, world.valid, world.seats)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, params)
    tworld = thex.Hex.initial(1, boardsize, device="cpu")
    tmodel = FCModel(tworld.obs_space, tworld.action_space, width=width, depth=depth, device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmake_eval_fn(jmodel, params), make_eval_fn(tmodel)


def _worlds(boardsize, n_envs, plies, seed):
    rng = np.random.default_rng(seed)
    world = jhex.Hex.initial(n_envs, boardsize)
    step = jax.jit(lambda w, a: w.step(a))
    for ply in range(plies):
        valid = np.asarray(world.valid)
        a = np.array([rng.choice(np.flatnonzero(v)) for v in valid], np.int32)
        world, _ = step(world, jnp.asarray(a))
    return world


def _t(x):
    return torch.tensor(np.asarray(x))


def _port_tree(jt):
    """A JAX tree's arrays as a port Tree (the fields root() reads)."""
    return TS.Tree(
        children=_t(jt.children).to(torch.int8), parents=_t(jt.parents), relation=_t(jt.relation),
        worlds=None, seats=_t(jt.seats), terminal=_t(jt.terminal), rewards=_t(jt.rewards),
        logits=_t(jt.logits), v=_t(jt.v), n=_t(jt.n), w=_t(jt.w),
        n_edge=_t(np.asarray(jt.n_edge, np.float32)).to(torch.bfloat16), w_edge=_t(jt.w_edge),
        c_puct=_t(jt.c_puct), sim=int(jt.sim), prew=_t(jt.prew))


@pytest.mark.parametrize("seed,plies", [(11, 6), (12, 11)])
def test_grow_search_matches_jax(seed, plies):
    B, n_nodes, K = 8, 13, 4
    jeval, teval = _models(seed=seed)
    jworld = _worlds(5, B, plies, seed)
    key = jax.random.PRNGKey(seed)

    jcfg = S.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K, use_pallas=False,
                        grow_passes=True, pallas_walk=False, sample_cum="shift")
    jt = jax.jit(lambda w, k: S.mcts(w, jeval, k, jcfg))(jworld, key)
    jroot = jax.jit(S.root)(jt)

    tworld = thex.Hex(board=_t(jworld.board), seats=_t(jworld.seats))
    tcfg = TS.MCTSConfig(n_nodes=n_nodes, leaves_per_pass=K)
    n0, w0 = kernels.node_actions_multi.launches, kernels.walk.launches
    tt = TS.mcts(tworld, teval, JaxDraws(key), tcfg)
    troot = TS.root(tt)
    # on the CPU the wrappers run their twins and count no launch
    assert (kernels.node_actions_multi.launches, kernels.walk.launches) == (n0, w0)

    assert tt.sim == int(jt.sim) == n_nodes
    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(jt.n_edge, np.float32))
    np.testing.assert_array_equal(tt.worlds.board.numpy(), np.asarray(jt.worlds.board))
    np.testing.assert_array_equal(tt.worlds.seats.numpy(), np.asarray(jt.worlds.seats))
    for name in ("w", "w_edge", "v", "prew", "rewards", "logits"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name), np.float32),
                                   atol=1e-5, err_msg=name)

    jl, tl = np.asarray(jroot["logits"]), troot["logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=1e-5)
    # root() alone, on the JAX tree's own arrays
    same = TS.root(_port_tree(jt))["logits"].numpy()
    np.testing.assert_allclose(same[fin], jl[fin], atol=1e-5)
    np.testing.assert_array_equal(np.isneginf(troot["prior"].numpy()), np.isneginf(np.asarray(jroot["prior"])))
    np.testing.assert_allclose(troot["v"].numpy(), np.asarray(jroot["v"]), atol=1e-5)
    np.testing.assert_array_equal(TS.n_leaves(tt).numpy(), np.asarray(S.n_leaves(jt)))
    # the root gets 2 visits (one per seat) from every draw of every pass
    assert (tt.n[:, 0] == 2 * K * tcfg.n_passes).all()


def test_config_refuses_what_the_slice_does_not_carry():
    for kwargs in ({"leaves_per_pass": 1}, {"grow_passes": False}, {"backup_mode": "einsum"},
                   {"warm_solve": True}, {"n_nodes": 200}):
        with pytest.raises(ValueError):
            TS.MCTSConfig(**kwargs)


def test_agent_runs_on_cpu():
    _, teval = _models()
    world = thex.Hex.initial(4, 5, device="cpu")
    agent = TS.MCTSAgent(teval, seed=1, n_nodes=9, leaves_per_pass=4)
    out = agent(world)
    assert out["actions"].shape == (4,) and out["actions"].dtype == torch.int32
    assert world.valid[torch.arange(4), out["actions"].long()].all()
    greedy = agent(world, eval=True)
    assert torch.equal(greedy["actions"], torch.argmax(greedy["logits"], -1).to(torch.int32))
    # the agent keeps one generator: a second search draws other noise
    assert not torch.equal(agent(world)["logits"], out["logits"])
