"""The gradient noise-scale study. Counterpart of boardlaw_tpu/noisescales.py.

The critical batch size from gradient statistics, measured (a) online from
Adam's moments while training (`learning.noise_scale`, logged by
`train.run`); (b) offline per stored agent: a fresh self-play chunk with the
agent's own search settings, per-timestep policy, value and joint
gradients, and their components in the results database's `noise_scales`
(`evaluate_noise_scale`); (c) over a run's snapshots and test-search
settings (`sweep`), in training (`NoiseScales`), and joined onto the agents
for analysis (`load`, needs pandas).

The fields are the JAX package's: mean_sq = |mean_t g_t|^2 per parameter,
sq_mean = mean_t |g_t|^2 per parameter, variance = the per-parameter
variance over timesteps with the T/(T-1) correction, all float32. Noise
scale B_crit ~ batch_size * variance / mean_sq (McCandlish et al.).

Flat gradients list the parameters in the JAX package's leaf order
(`models.convert.flax_order`, flax kernels transposed), so a (T, n_params)
matrix of the port equals the JAX package's column for column. Where the
JAX package differentiates each timestep with `jax.grad` under a `lax.scan`,
the port loops over the timesteps with `torch.autograd.grad`. The chunk's
searches take `draws.split()` where the JAX package splits its key, and run
on `device`, the card unless the caller asks for another.
"""
from __future__ import annotations

from logging import getLogger

import numpy as np
import torch

from . import learning, sql
from .draws import Draws
from .envs import hex
from .mcts.search import MCTSAgent
from .models import convert
from .models.networks import make_eval_fn
from .pavlov import stats as pstats
from .utils import resolve_device

log = getLogger(__name__)

NODE_SWEEP = [1, 2, 4, 8, 16, 32, 64]
C_SWEEP = [1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0]

KINDS = ("policy", "value", "joint")


# ---------------------------------------------------------------------------
# Gradient statistics
# ---------------------------------------------------------------------------

def _flat(tree):
    """The leaves of a tensor, dict (keys sorted) or list, flattened and
    concatenated."""
    if torch.is_tensor(tree):
        return tree.reshape(-1)
    if isinstance(tree, dict):
        return torch.cat([_flat(tree[k]) for k in sorted(tree)])
    return torch.cat([_flat(x) for x in tree])


def gradient_stats(grad_fn, batches):
    """The noise-scale components of `grad_fn(batch)` (a gradient tensor,
    dict or list) over equal-size batches."""
    return flat_gradient_stats(torch.stack([_flat(grad_fn(b)) for b in batches]))


def flat_gradient_stats(G):
    """Components from a stacked (K, P) float32 gradient matrix."""
    K = G.shape[0]
    mean_g = G.mean(0)
    bessel = K / max(K - 1, 1)
    return {
        "mean_sq": float(mean_g.square().mean()),
        "sq_mean": float(G.square().mean()),
        "variance": float((G - mean_g[None]).square().mean(0).mean() * bessel),
        "n_params": float(G.shape[1]),
        "batches": float(K),
    }


def noise_scale(stats, batch_size):
    """B_crit ~ batch * var / |mean grad|^2."""
    return batch_size * stats["variance"] / max(stats["mean_sq"], 1e-12)


def _flat_grad(model, loss, retain_graph=False):
    """d loss / d parameters as one flat vector in the JAX leaf order (zeros
    for parameters the loss does not use, as `jax.grad` gives)."""
    order = convert.flax_order(model)
    params = [p for _, p, _ in order]
    grads = torch.autograd.grad(loss, params, retain_graph=retain_graph, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return torch.cat([(g.T if t else g).reshape(-1) for g, (_, _, t) in zip(grads, order)])


def measure(model, batch, loss_fn, n_slices=8, batch_size=None):
    """Split a batch (a dict of tensors with a leading batch axis) into
    `n_slices` equal slices and measure the gradient statistics of
    `loss_fn(model, sub_batch) -> scalar`."""
    B = next(iter(batch.values())).shape[0]
    k = B // n_slices
    slices = ({key: x[i * k:(i + 1) * k] for key, x in batch.items()} for i in range(n_slices))
    stats = flat_gradient_stats(torch.stack([_flat_grad(model, loss_fn(model, b))
                                             for b in slices]))
    stats["batch_size"] = float(batch_size or k)
    return stats


# ---------------------------------------------------------------------------
# The offline per-agent study: a fresh chunk, per-timestep gradients, SQL
# ---------------------------------------------------------------------------

def _agent_assets(agent_id, device=None):
    """(model, MCTSAgent, boardsize) of a results-database agent: the
    snapshot's weights searched with the row's `test_nodes` and `test_c`
    (and `MCTSAgent`'s other defaults)."""
    from . import train
    from .arena import common
    from .pavlov import runs, storage as pstorage

    info = sql.agent_query().row(int(agent_id))
    run = runs.resolve(info.run)
    cfg = common._train_config(pstorage.load_raw(run, "model")["cfg"])
    model = train.build_model(cfg, device=device)
    sd = pstorage.load_snapshot(run, int(info.idx))
    model.load_state_dict(common._state_dict(sd["agent"]))
    agent = MCTSAgent(make_eval_fn(model), n_nodes=int(info.test_nodes),
                      c_puct=float(info.test_c))
    return model, agent, int(info.boardsize)


def collect(agent_id, n_envs=1024, chunk_len=64, max_mixness=0.25, seed=0, draws=None,
            device=None):
    """Self-play a fresh (T, B) chunk with the stored agent, collecting
    again after more play while the terminals are lumped in time. Returns
    (model, chunk): obs/valid/seats, the search targets (logits, v),
    rewards, terminal and reward_to_go, all (T, B, ...)."""
    device = resolve_device(device)
    model, agent, boardsize = _agent_assets(agent_id, device)
    world = hex.Hex.initial(n_envs, boardsize, device=device)
    draws = draws if draws is not None else Draws(seed, device)

    def chunk_step(world, d):
        dec = agent(world, d)
        new_world, transition = world.step(dec["actions"])
        rec = {"obs": world.obs, "valid": world.valid, "seats": world.seats,
               "logits": dec["logits"], "v": dec["v"], "rewards": transition.rewards,
               "terminal": transition.terminal}
        return new_world, rec

    buffer = []
    for _ in range(8):
        for _ in range(chunk_len):
            world, rec = chunk_step(world, draws.split())
            buffer.append(rec)
        buffer = buffer[-chunk_len:]
        chunk = {k: torch.stack([r[k] for r in buffer]) for k in buffer[0]}
        per_t = chunk["terminal"].float().mean(1).cpu().numpy()
        med = max(float(np.median(per_t)), 1e-6)
        mixness = (per_t.max() - per_t.min()) / med
        if mixness < max_mixness:
            break
        log.info(f"collect({agent_id}): mixness {mixness:.2f}, re-collecting")

    term = chunk["terminal"][..., None].expand(chunk["rewards"].shape)
    chunk["reward_to_go"] = learning.reward_to_go(chunk["rewards"], chunk["v"], term)
    return model, chunk


def _chunk_losses(model, batch):
    """The policy and value losses over one timestep's batch: the forms the
    trainer optimises."""
    d = model(batch["obs"], batch["valid"], batch["seats"])
    zeros = torch.zeros_like(d["logits"])
    logits = torch.where(d["logits"] > -torch.inf, d["logits"], zeros)
    target = batch["logits"].float()
    target = torch.where(target > -torch.inf, target, zeros)
    policy = -(torch.exp(target) * logits).sum(-1).mean()
    value = (batch["reward_to_go"] - d["v"]).square().mean()
    return policy, value


def gradients(model, chunk):
    """Per-timestep flat policy, value and joint gradients, (T, n_params)
    each, in the JAX leaf order."""
    T = chunk["obs"].shape[0]
    out = {k: [] for k in KINDS}
    for t in range(T):
        policy, value = _chunk_losses(model, {k: x[t] for k, x in chunk.items()})
        fp = _flat_grad(model, policy, retain_graph=True)
        fv = _flat_grad(model, value)
        for k, g in zip(KINDS, (fp, fv, fp + fv)):
            out[k].append(g)
    return {k: torch.stack(v) for k, v in out.items()}


def _rows(agent_id):
    return sql.query("select * from noise_scales where agent_id == ?", int(agent_id))


def evaluate_noise_scale(agent_id, n_envs=1024, chunk_len=64, draws=None, device=None):
    """Collect, measure and persist one agent's noise-scale rows (one per
    kind); an agent with rows already is left as it is. Returns its rows."""
    extant = _rows(agent_id)
    if len(extant):
        return extant
    model, chunk = collect(agent_id, n_envs=n_envs, chunk_len=chunk_len, draws=draws,
                           device=device)
    fields = {k: chunk[k] for k in ("obs", "valid", "seats", "logits", "reward_to_go")}
    gs = gradients(model, fields)
    B = chunk["obs"].shape[1]
    for kind, G in gs.items():
        comp = flat_gradient_stats(G)
        comp["batch_size"] = float(B)
        sql.save_noise_scale(int(agent_id), kind, **comp)
        log.info(f"{agent_id}/{kind}: noise scale {noise_scale(comp, B):.0f}")
    return _rows(agent_id)


def agents_opponent(agent_id, nodes=64, c=1 / 16):
    """The agent of the same snapshot at the canonical search settings, the
    yardstick of `evaluate_perf`."""
    rows = sql.query(
        "select agents.id from agents where snap == "
        "(select snap from agents where id == ?) and nodes == ? and c == ?",
        int(agent_id), int(nodes), float(c))
    return int(rows.id[0])


def evaluate_perf(agent_id, n_envs=256, draws=None, device=None):
    """Play the agent against its snapshot's canonical agent and persist
    the trials, unless `n_envs` games between them are there already."""
    from .arena import common

    opponent_id = agents_opponent(agent_id)
    extant = sql.query(
        "select * from trials where ((black_agent == ?) and (white_agent == ?))"
        " or ((white_agent == ?) and (black_agent == ?))",
        int(agent_id), int(opponent_id), int(agent_id), int(opponent_id))
    games = (extant.black_wins + extant.white_wins).sum() if len(extant) else 0
    if games >= n_envs:
        return
    a = common.sql_agent(agent_id, device=device)
    o = common.sql_agent(opponent_id, device=device)
    w = common.sql_world(agent_id, n_envs, device=device)
    results = common.evaluate(w, [(agent_id, a), (opponent_id, o)], draws=draws)
    sql.save_trials((int(r["names"][0]), int(r["names"][1]), int(r["wins"][0]),
                     int(r["wins"][1]), int(r["moves"]), float(r["times"])) for r in results)


def evaluate(run, idx, nodes, c_puct, perf=True, n_envs=1024, chunk_len=64, draws=None,
             device=None):
    """Register the (snapshot, nodes, c) agent where it is absent, then
    measure its noise scale (and, with `perf`, its trials against the
    canonical agent): the unit of a sweep. Returns the agent id."""
    snap = sql.query("select id from snaps where run == ? and idx == ?", run, int(idx))
    if not len(snap):
        raise KeyError(f"no snapshot {run}/{idx}: run sql.refresh() first")
    snap_id = int(snap.id[0])
    q = "select * from agents where snap == ? and nodes == ? and c == ?"
    extant = sql.query(q, snap_id, int(nodes), float(c_puct))
    if not len(extant):
        sql.execute("insert into agents values (null, ?, ?, ?)", snap_id, int(nodes),
                    float(c_puct))
        extant = sql.query(q, snap_id, int(nodes), float(c_puct))
    agent_id = int(extant.id[0])
    evaluate_noise_scale(agent_id, n_envs=n_envs, chunk_len=chunk_len, draws=draws,
                         device=device)
    if perf:
        evaluate_perf(agent_id, draws=draws, device=device)
    return agent_id


def sweep(run, idxs=None, nodes=None, cs=None, perf=False, n_envs=1024, device=None):
    """`evaluate` over a run's snapshots and the test-search settings, one
    unit after another on one card."""
    sql.refresh()
    snaps = sql.query("select * from snaps where run == ?", run)
    idxs = np.unique(snaps.idx) if idxs is None else idxs
    done = []
    for idx in idxs:
        for n in nodes or NODE_SWEEP:
            for c in cs or C_SWEEP:
                done.append(evaluate(run, idx, n, c, perf=perf, n_envs=n_envs, device=device))
    return done


def load():
    """The measured noise scales (a column per kind) joined onto the agents'
    details, with `params` and `tree_spec` (needs pandas)."""
    from .pavlov import runs

    pd = runs.require_pandas()
    details = sql.agent_query().frame()
    noise = (
        sql.query("select * from noise_scales").frame()
        .set_index(["agent_id", "kind"])
        .pipe(lambda df: df.batch_size * df.variance / df.mean_sq)
        .unstack()
    )
    df = pd.merge(details, noise, left_index=True, right_index=True, how="inner")
    df["params"] = df.width**2 * df.depth
    df["tree_spec"] = df.test_c.astype(str) + "/" + df.test_nodes.astype(str)
    return df


# ---------------------------------------------------------------------------
# In training
# ---------------------------------------------------------------------------

class NoiseScales:
    """Every `buffer_len` steps, the per-timestep gradient noise over the
    current chunk, its components and scales logged through pavlov's stats
    (`noise.<field>.<kind>` silently, a field `x`; `noise.<kind>` as a
    mean). The JAX package passes the silent kind its value by position,
    which its `Silent.write` refuses with a TypeError inside a run."""

    def __init__(self, model, buffer_len=64):
        self._model = model
        self._count = 0
        self._buffer_len = buffer_len

    def step(self, chunk):
        if self._count % self._buffer_len == 0:
            gs = gradients(self._model, chunk)
            B = chunk["obs"].shape[1]
            for kind, G in gs.items():
                comp = flat_gradient_stats(G)
                comp["batch_size"] = float(B)
                for k, v in comp.items():
                    pstats.silent(f"noise.{k}.{kind}", x=v)
                pstats.mean(f"noise.{kind}", noise_scale(comp, B))
        self._count += 1


def persist(agent_id, kind, stats):
    """Record a measurement in the results database."""
    sql.save_noise_scale(agent_id, kind, **stats)
