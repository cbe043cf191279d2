"""The port's planted-value games and proxy agents (`envs/validation.py`)
against the JAX package's, and the search cases of tests/test_mcts.py
(`test_trivial` ... `test_dummy_agent`) on the port's search.

* Every game's `step`, `valid`, `obs`, `v`, `logits` and `seats` equal the
  JAX package's over random action sequences (values to f32 roundoff, the
  rest exactly).
* `ProxyAgent` and `RandomAgent` equal JAX's. The JAX `MonteCarloAgent`
  cannot run: its rollout body converts a traced value to a bool
  (`first = actions if t == 0 else None`, boardlaw_tpu/envs/validation.py:76,
  an unused line) and raises under `lax.while_loop`. So the port's agent is
  held against `_jax_monte_carlo`, the JAX agent's algorithm without that
  line, in JAX ops on JAX's key chain, under fed draws: each rollout's
  stream is `draws.split()`, fed from the split of JAX's key, so both sides
  draw the same Gumbel noise in the same order.
* `test_planted_game`, `test_agent_protocol` and `test_dummy_agent` of
  tests/test_mcts.py at K=1 and at K=8 with grow passes, each held against
  the JAX package's XLA search (or agent) under the same draws (the
  `JaxDraws` seam of tests/test_torch_search.py): children, parents and
  visit counts equal, values to 1e-5. The planted 3x3 Hex game runs in
  `PLANTED_ENVS` copies, each with its own draws: the JAX test's
  inequalities on the root policy hold for its one key, not for every
  draw, and the JAX search misses them in a few copies (1 of 512 at K=1,
  4 of 256 at K=8, on key 3's draws). The port's search misses them in
  exactly the same copies, and holds them in at least 95%. The other
  search cases, on
  the planted-value games, are tests/test_torch_validation_search.py, with
  the helpers here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex, validation as jval
from boardlaw_tpu.mcts import search as S
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex, validation as tval
from boardlaw_tpu_torch.mcts import search as TS
from test_torch_search import JaxDraws
from test_torch_search_k1 import JaxK1Draws

torch.set_num_threads(2)

# name -> (world maker taking the module and n_envs, extra kwargs of initial)
GAMES = {
    "Win": (lambda m, B, **kw: m.Win.initial(n_envs=B, **kw)),
    "WinnerLoser": (lambda m, B, **kw: m.WinnerLoser.initial(n_envs=B, **kw)),
    "All": (lambda m, B, **kw: m.All.initial(n_envs=B, length=3, **kw)),
    "All2": (lambda m, B, **kw: m.All.initial(n_envs=B, n_seats=2, length=3, **kw)),
    "dilemma": (lambda m, B, **kw: m.SequentialMatrix.dilemma(n_envs=B, **kw)),
    "antisymmetric": (lambda m, B, **kw: m.SequentialMatrix.antisymmetric(n_envs=B, **kw)),
}


def _jworld(name, B):
    return GAMES[name](jval, B)


def _tworld(name, B):
    return GAMES[name](tval, B, device="cpu")


def _fields(world):
    return {f: getattr(world, f) for f in ("valid", "obs", "v", "logits", "seats")}


def _same(t, j, what):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7, err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


@pytest.mark.parametrize("name", list(GAMES))
def test_games_match_jax(name):
    rng = np.random.default_rng(len(name))
    B = 8
    jw, tw = _jworld(name, B), _tworld(name, B)
    assert (tw.n_seats, tw.obs_space, tw.action_space) == (jw.n_seats, tuple(jw.obs_space),
                                                           tuple(jw.action_space))
    jstep = jax.jit(lambda w, a: w.step(a))
    n_terminal = 0
    for ply in range(12):
        for k, v in _fields(tw).items():
            _same(v, getattr(jw, k), f"{k} ply {ply}")
        actions = np.array([rng.choice(np.flatnonzero(v)) for v in tw.valid.numpy()], np.int32)
        jw, jtr = jstep(jw, jnp.asarray(actions))
        tw, ttr = tw.step(torch.from_numpy(actions))
        _same(ttr.terminal, jtr.terminal, f"terminal ply {ply}")
        _same(ttr.rewards, jtr.rewards, f"rewards ply {ply}")
        n_terminal += int(ttr.terminal.sum())
    assert n_terminal > 0


class _ChainDraws(Draws):
    """JAX's key chain as the port's draws: each Gumbel draw takes the next
    split of the key, and `split()` hands a sub-stream the next split as its
    own key (as `MonteCarloAgent` splits per rollout in JAX)."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        self.key = key

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def gumbel(self, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(self._next(), tuple(shape))))

    def split(self):
        return _ChainDraws(self._next())


def test_proxy_and_random_agents_match_jax():
    for name in ("All2", "dilemma"):
        jw, tw = _jworld(name, 4), _tworld(name, 4)
        jp, tp = jval.ProxyAgent()(jw), tval.ProxyAgent()(tw)
        for k in ("logits", "v"):
            _same(tp[k], jp[k], k)
    jw = jhex.Hex.initial(n_envs=6, boardsize=3)
    tw = thex.Hex.initial(n_envs=6, boardsize=3, device="cpu")
    key = jax.random.PRNGKey(1)
    jr = jval.RandomAgent()(jw, key)
    draws = _ChainDraws(None)
    draws.gumbel = lambda shape: torch.tensor(np.asarray(jax.random.gumbel(key, tuple(shape))))
    tr = tval.RandomAgent()(tw, draws)
    for k in ("logits", "v", "actions"):
        _same(tr[k], jr[k], k)
    assert "actions" not in tval.RandomAgent()(tw)


def test_jax_monte_carlo_agent_cannot_run():
    # the reference's fault (not the port's): its rollout body branches on a
    # traced value
    agent = jval.MonteCarloAgent(n_rollouts=1)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        agent(jhex.Hex.initial(n_envs=2, boardsize=3), jax.random.PRNGKey(0))


def _jax_monte_carlo(world, key, n_rollouts, temperature, max_steps=256):
    """`boardlaw_tpu.envs.validation.MonteCarloAgent.__call__` without its
    failing line, the rollout's `lax.while_loop` as a Python loop: the same
    key splits, categoricals and sums, in JAX ops."""
    step = jax.jit(lambda w, a: w.step(a))
    B, A = world.valid.shape
    envs = jnp.arange(B)

    def rollout(world, key):
        key, sub = jax.random.split(key)
        first = jax.random.categorical(sub, jval.uniform_logits(world.valid), axis=-1)
        world, tr = step(world, first)
        reward, live, t = tr.rewards, ~tr.terminal, 1
        while bool(live.any()) and t < max_steps:
            key, sub = jax.random.split(key)
            actions = jax.random.categorical(sub, jval.uniform_logits(world.valid), axis=-1)
            world, tr = step(world, actions)
            reward = reward + tr.rewards * live[:, None]
            live = live & ~tr.terminal
            t += 1
        return reward, first

    totals = jnp.zeros((B, A, world.n_seats))
    counts = jnp.zeros((B, A, world.n_seats))
    for _ in range(n_rollouts):
        key, sub = jax.random.split(key)
        r, a = rollout(world, sub)
        totals = totals.at[envs, a].add(r)
        counts = counts.at[envs, a].add(1.0)
    means = jnp.where(counts > 0, totals / jnp.maximum(counts, 1), 0.0)
    seat_means = means[envs, :, world.seats.astype(jnp.int32)]
    logits = jax.nn.log_softmax(temperature * seat_means, axis=-1)
    logits = jnp.where(world.valid, logits, -jnp.inf)
    key, sub = jax.random.split(key)
    return {"logits": logits, "actions": jax.random.categorical(sub, logits, axis=-1),
            "v": totals.sum(-2) / jnp.maximum(counts.sum(-2), 1)}


@pytest.mark.parametrize("world_name", ["hex3", "All2"])
def test_monte_carlo_agent_matches_jax_under_fed_draws(world_name):
    if world_name == "hex3":
        jw = jhex.Hex.initial(n_envs=4, boardsize=3)
        tw = thex.Hex.initial(n_envs=4, boardsize=3, device="cpu")
    else:
        jw, tw = _jworld("All2", 4), _tworld("All2", 4)
    key = jax.random.PRNGKey(7)
    jout = _jax_monte_carlo(jw, key, n_rollouts=3, temperature=2.0)
    tout = tval.MonteCarloAgent(n_rollouts=3, temperature=2.0)(tw, _ChainDraws(key))
    _same(tout["actions"], jout["actions"], "actions")
    np.testing.assert_allclose(tout["v"].numpy(), np.asarray(jout["v"]), atol=1e-6)
    jl, tl = np.asarray(jout["logits"]), tout["logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    np.testing.assert_allclose(tl[np.isfinite(jl)], jl[np.isfinite(jl)], atol=1e-6)


# --------------------------------------------------------------------------
# The search cases
# --------------------------------------------------------------------------

# name -> (world, n_envs, n_nodes, MCTSConfig kwargs, analytic root value)
SEARCHES = {
    "trivial": ("Win", 1, 3, {}, [[1.0]]),
    "two_player": ("WinnerLoser", 1, 3, {}, [[1.0, -1.0]]),
    "depth": ("All", 1, 15, {"noise_eps": 0.0}, [[1 / 8]]),
    "multienv": ("All", 2, 15, {"noise_eps": 0.0}, [[1 / 8], [1 / 8]]),
    "two_seats": ("All2", 2, 15, {"noise_eps": 0.0}, [[1 / 8, 1 / 8]] * 2),
    "dilemma": ("dilemma", 4, 15, {}, [[0.0, 0.0]] * 4),
}
ROUTES = {
    "k1": {},
    "k8-grow": {"leaves_per_pass": 8, "grow_passes": True},
    "k8-scan": {"leaves_per_pass": 8, "grow_passes": False},
}
PLANTED_ENVS = 128
PLANTED = """
    wb.
    bw.
    wb.
    """


def _jax_cfg(route, n_nodes, **kw):
    if route == "k1":
        return S.MCTSConfig(n_nodes=n_nodes, use_pallas=False, pallas_nodes=False,
                            pallas_walk=False, **kw)
    return S.MCTSConfig(n_nodes=n_nodes, use_pallas=False, pallas_walk=False, sample_cum="shift",
                        **ROUTES[route], **kw)


def _draws(route, key, n_nodes):
    return JaxK1Draws(key, n_nodes - 1) if route == "k1" else JaxDraws(key)


def _jax_search(case, route, seed):
    """The JAX package's tree and root for a search case by `route`."""
    if case == "planted":
        world, agent = jhex.from_string(PLANTED), jval.RandomAgent()
        world = jax.tree.map(lambda x: jnp.repeat(x, PLANTED_ENVS, 0), world)
        cfg = _jax_cfg(route, 63, c_puct=1.0, noise_eps=0.0)
    else:
        game, B, n_nodes, kw, _ = SEARCHES[case]
        world, agent = _jworld(game, B), jval.ProxyAgent()
        cfg = _jax_cfg(route, n_nodes, **kw)
    tree = jax.jit(lambda w, k: S.mcts(w, agent, k, cfg))(world, jax.random.PRNGKey(seed))
    return tree, jax.jit(S.root)(tree)


def _port_search(case, route, seed):
    key = jax.random.PRNGKey(seed)
    if case == "planted":
        world, agent = thex.from_string(PLANTED, device="cpu"), tval.RandomAgent()
        world = thex.Hex(board=world.board.repeat(PLANTED_ENVS, 1, 1),
                         seats=world.seats.repeat(PLANTED_ENVS))
        kw, n_nodes = {"c_puct": 1.0, "noise_eps": 0.0}, 63
    else:
        game, B, n_nodes, kw, _ = SEARCHES[case]
        world, agent = _tworld(game, B), tval.ProxyAgent()
    cfg = TS.MCTSConfig(n_nodes=n_nodes, **kw, **ROUTES[route])
    tree = TS.mcts(world, agent, _draws(route, key, n_nodes), cfg)
    return tree, TS.root(tree)


def _hold_against_jax(tt, jt, troot, jroot):
    assert tt.sim == int(jt.sim)
    for name in ("children", "parents", "relation", "n", "seats", "terminal"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jt, name)).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.n_edge.float().numpy(), np.asarray(jt.n_edge, np.float32))
    for name in ("w", "w_edge", "v", "rewards"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name), np.float32), atol=1e-5,
                                   err_msg=name)
    jl, tl = np.asarray(jroot["logits"]), troot["logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    np.testing.assert_allclose(tl[np.isfinite(jl)], jl[np.isfinite(jl)], atol=1e-5)
    np.testing.assert_allclose(troot["v"].numpy(), np.asarray(jroot["v"]), atol=1e-5)


def planted_holds(logits):
    """Per env, the JAX test's inequalities on the root policy of the
    planted 3x3 game: cells 2 and 5 above 8 and 7."""
    probs = np.exp(np.asarray(logits))
    return (probs[:, 2] > probs[:, 8]) & (probs[:, 5] > probs[:, 7])


@pytest.mark.parametrize("route", ["k1", "k8-grow"])
def test_planted_game(route):
    # a competitive 3x3 position where cells 2 and 5 are the key ones
    tt, troot = _port_search("planted", route, seed=3)
    jt, jroot = _jax_search("planted", route, 3)
    _hold_against_jax(tt, jt, troot, jroot)
    holds = planted_holds(troot["logits"].numpy())
    np.testing.assert_array_equal(holds, planted_holds(jroot["logits"]))
    assert holds.mean() >= 0.95


class _AgentDraws(JaxK1Draws):
    """The draws of the JAX `MCTSAgent(world, key)`: the search from the
    first split of the key, the action's Gumbel noise from the second."""

    def __init__(self, key, n_sims):
        k_search, self.k_act = jax.random.split(key)
        super().__init__(k_search, n_sims)

    def gumbel(self, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(self.k_act, tuple(shape))))


@pytest.mark.parametrize("route", ["k1", "k8-grow"])
def test_agent_protocol(route):
    world = thex.Hex.initial(n_envs=4, boardsize=3, device="cpu")
    kw = dict(ROUTES[route], n_nodes=8)
    agent = TS.MCTSAgent(tval.RandomAgent(), **kw)
    key = jax.random.PRNGKey(0)
    decisions = agent(world, _AgentDraws(key, 7))
    assert decisions["actions"].shape == (4,)
    assert decisions["logits"].shape == (4, 9)
    assert decisions["v"].shape == (4, 2)
    valid = world.valid.numpy()
    acts = decisions["actions"].numpy()
    assert all(valid[e, acts[e]] for e in range(4))

    jkw = _jax_cfg(route, 8).__dict__
    jagent = S.MCTSAgent(jval.RandomAgent(), **{k: v for k, v in jkw.items()
                                                 if k not in ("mesh", "mesh_axis")})
    jd = jax.jit(lambda w, k: jagent(w, k))(jhex.Hex.initial(n_envs=4, boardsize=3), key)
    for k in ("actions", "n_sims", "n_leaves"):
        np.testing.assert_array_equal(decisions[k].numpy(), np.asarray(jd[k]), err_msg=k)
    np.testing.assert_allclose(decisions["logits"].numpy(), np.asarray(jd["logits"]), atol=1e-5)


def test_dummy_agent():
    world = thex.Hex.initial(n_envs=4, boardsize=3, device="cpu")
    key = jax.random.PRNGKey(0)
    draws = _ChainDraws(None)
    draws.gumbel = lambda shape: torch.tensor(np.asarray(jax.random.gumbel(key, tuple(shape))))
    decisions = TS.DummyAgent(tval.RandomAgent())(world, draws)
    assert decisions["actions"].shape == (4,)
    assert decisions["n_sims"].tolist() == [0, 0, 0, 0]
    jd = jax.jit(lambda w, k: S.DummyAgent(jval.RandomAgent())(w, k))(
        jhex.Hex.initial(n_envs=4, boardsize=3), key)
    np.testing.assert_array_equal(decisions["actions"].numpy(), np.asarray(jd["actions"]))
