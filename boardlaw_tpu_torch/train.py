"""The actor-learner self-play training step. Counterpart of
boardlaw_tpu/train.py's `make_train`: a circular buffer of the last
`buffer_len` self-play steps feeds a learner that each step samples one
timestep per env and takes one Adam step on the policy cross-entropy against
the search's root targets plus the value MSE against reward-to-go.

`train_step` is one `actor_record` (a search per env, a draw from the
improved root policy, one `Hex.step`), the buffer push, reward-to-go over the
time-ordered buffer, the per-env batch gather and the Adam step. The JAX
package's state donation becomes in-place updates of the `TrainState`; its
chunked warmup (a TPU runtime workaround) is a plain loop.

`make_config`/`best_config` carry `run`/`run_best`'s configuration rules.

`run` is the entry point that trains an agent and keeps it: a run directory
in the JAX package's layout (`pavlov`), its log, the loop's stats channels,
a `TimeStorer` or `FlopsStorer` that writes log-spaced snapshots and a
throttled `latest` (`storage`), and `resume=`, which continues a run, the
port's or one the JAX package wrote, from its latest checkpoint.
`state_dict`/`load_state_dict` are the checkpoint's agent part.

Data parallelism (`parallel/`): a `TrainState` that carries a mesh holds
one rank's block of the envs (`cfg.n_envs` stays the global count, as in
JAX) and a replica of the model and its Adam state. Its `train_step`
all-reduces the gradient (averaged) before the Adam step, so every rank
applies the same update, and makes the aux global, so every rank holds
what the single process logs; the search all-reduces its q-bounds. With
the sharded view of the same draws (`Draws.shard`), the world computes the
single-process step up to the all-reduce's order of summation.
`run(n_devices=n)` spawns n such ranks.
"""
from __future__ import annotations

import copy
import time
from contextlib import ExitStack
from dataclasses import dataclass, fields
from functools import partial
from logging import getLogger

import torch

from . import learning, storage as bstorage
from .draws import Draws, ShardedDraws
from .envs import hex
from .mcts import MCTSConfig, mcts as run_mcts, root as mcts_root, n_leaves
from .mcts.search import _map_world
from .models import convert
from .models.networks import AZTower, FCModel, make_eval_fn
from .pavlov import device as pdevice, logs, runs, stats, storage as pstorage
from .utils import resolve_device
from .utils.profiling import count, span

log = getLogger(__name__)

# spans (utils.profiling)
STEP = "train.step"
ACTOR = "train.actor"
ACT = "train.act"
LEARNER = "train.learner"
SYNC_AUX = "sync.train.aux"
SYNC_ORDERED = "sync.train.ordered"

# Best-known hyperparameters per boardsize (reference main.py:17-25):
# boardsize -> (width, depth, nodes, c_puct)
BEST = {
    3: (2, 4, 64, 1 / 16),
    4: (8, 2, 64, 1 / 16),
    5: (16, 4, 64, 1 / 16),
    6: (128, 1, 64, 1 / 16),
    7: (128, 4, 64, 1 / 16),
    8: (256, 4, 64, 1 / 16),
    9: (512, 4, 64, 1 / 16),
}


@dataclass(frozen=True)
class TrainConfig:
    """The fields that change what a train step computes. The defaults are
    the JAX package's (K=1, the sequential search); `make_config` applies
    `run`'s switch to K=8 grow passes for boards of 7 and up. The search
    fields are `MCTSConfig`'s; `solve_kernel` and `sample_kernel` are the
    port's counterparts of the JAX `pallas_nodes`/`pallas_solve` and
    `pallas_sample` switches. `dtype` (the network's compute type) and
    `tree_dtype` (the tree's logits) are torch dtype names, "float32" or
    "bfloat16" (the JAX flagship runs both in bf16). `net` is the network
    (`NETS`): "fc", the paper's ReZero tower, or "az", AlphaGo Zero's
    convolutional residual tower with batch norm (`width` filters, `depth`
    residual blocks)."""

    boardsize: int
    width: int
    depth: int
    n_envs: int = 32 * 1024
    buffer_len: int = 64
    n_nodes: int = 64
    c_puct: float = 1 / 16
    noise_eps: float = 0.25
    lr: float = 1e-3
    mix_steps: int = 2500
    seed: int = 0  # the initial weights
    dtype: str = "float32"  # network compute dtype
    tree_dtype: str = "float32"  # MCTS tree logits storage
    # replay logits/prior storage; losses upcast to f32
    buffer_dtype: str = "bfloat16"
    leaves_per_pass: int = 1
    solve_iters: int = 6
    solve_accel: bool = True
    grow_passes: bool = False
    backup_mode: str = "prefix"
    warm_solve: bool = False
    sample_cum: str = "matmul"
    solve_kernel: str = "fused"
    sample_kernel: bool = False
    net: str = "fc"

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    def mcts_config(self, mesh=None):
        return MCTSConfig(
            n_nodes=self.n_nodes,
            c_puct=self.c_puct,
            noise_eps=self.noise_eps,
            leaves_per_pass=self.leaves_per_pass,
            solve_iters=self.solve_iters,
            solve_accel=self.solve_accel,
            grow_passes=self.grow_passes,
            backup_mode=self.backup_mode,
            warm_solve=self.warm_solve,
            sample_cum=self.sample_cum,
            solve_kernel=self.solve_kernel,
            sample_kernel=self.sample_kernel,
            tree_dtype=getattr(torch, self.tree_dtype),
            mesh=mesh,
        )


def make_config(boardsize, width, depth, nodes=64, c_puct=1 / 16, lr=1e-3, n_envs=32 * 1024,
                **overrides):
    """The config `run` trains with: boards of 7 and up default to the
    batched K=8 search with grow passes (boardlaw_tpu/train.py:451-465)."""
    if boardsize >= 7:
        overrides.setdefault("leaves_per_pass", 8)
        if overrides["leaves_per_pass"] > 1:
            overrides.setdefault("grow_passes", True)
    return TrainConfig(boardsize=boardsize, width=width, depth=depth, n_envs=n_envs,
                       n_nodes=nodes, c_puct=c_puct, lr=lr, **overrides)


def best_config(boardsize, **overrides):
    """`make_config` with the best-known hyperparameters of `BEST`."""
    width, depth, nodes, c_puct = BEST[boardsize]
    return make_config(boardsize, width, depth, nodes=nodes, c_puct=c_puct, **overrides)


NETS = {"fc": FCModel, "az": AZTower}


def build_model(cfg: TrainConfig, device=None, generator=None):
    """The config's network (`cfg.net`), in eval mode: only the learner's
    forward (`losses`) runs it in train mode."""
    if cfg.net not in NETS:
        raise ValueError(f"no network {cfg.net!r}; there are {sorted(NETS)}")
    world = hex.Hex.initial(1, cfg.boardsize, device="cpu")
    model = NETS[cfg.net](world.obs_space, world.action_space, width=cfg.width, depth=cfg.depth,
                          n_seats=world.n_seats, dtype=cfg.compute_dtype, device=device,
                          generator=generator)
    return model.eval()


def make_optimizer(cfg: TrainConfig, params):
    """`optax.adam(cfg.lr)`'s settings."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def local_envs(cfg: TrainConfig, mesh=None):
    """The envs one rank holds: all `cfg.n_envs`, or the mesh's block of
    them (ValueError unless they split evenly)."""
    if mesh is None:
        return cfg.n_envs
    blk = mesh.block(cfg.n_envs)
    return blk.stop - blk.start


def _check_draws(draws, mesh):
    """On a mesh every seam must draw the whole batch's numbers and keep
    this rank's block: the draws must be `Draws.shard(rank, size)`."""
    if mesh is not None and not (isinstance(draws, ShardedDraws)
                                 and (draws.rank, draws.world) == (mesh.rank, mesh.size)):
        raise ValueError(f"rank {mesh.rank} of {mesh.size} needs draws.shard({mesh.rank}, "
                         f"{mesh.size})")


def init_worlds(cfg: TrainConfig, draws: Draws, mesh=None):
    """`cfg.n_envs` decorrelated worlds (a mesh's block of them):
    `learning.mix` over fresh boards, on the device of `draws`."""
    _check_draws(draws, mesh)
    worlds = hex.Hex.initial(local_envs(cfg, mesh), cfg.boardsize, device=draws.device)
    return learning.mix(worlds, draws, cfg.mix_steps)


@span(ACTOR)
@torch.no_grad()
def actor_record(cfg: TrainConfig, model, worlds, draws: Draws, return_tree=False, mesh=None):
    """One self-play step for every env (of a mesh's rank: its block,
    searched with the global q-bounds): search, act, step. Returns the new
    worlds and the replay record of the pre-step state (and the search tree
    with `return_tree`)."""
    tree = run_mcts(worlds, make_eval_fn(model), draws, cfg.mcts_config(mesh))
    with span(ACT):
        r = mcts_root(tree)
        actions = torch.argmax(r["logits"] + draws.gumbel(r["logits"].shape), -1)
        new_worlds, transition = worlds.step(actions)
    bdt = getattr(torch, cfg.buffer_dtype)
    record = {
        "worlds": worlds,
        "logits": r["logits"].to(bdt),
        "prior": r["prior"].to(bdt),
        "v": r["v"].float(),
        "n_leaves": n_leaves(tree).to(torch.int32),
        "terminal": transition.terminal,
        "rewards": transition.rewards.float(),
    }
    return (new_worlds, record, tree) if return_tree else (new_worlds, record)


def make_actor(cfg: TrainConfig, model):
    """`actor_record` closed over a config and a model:
    ``actor(worlds, draws) -> (new_worlds, record)``."""
    return partial(actor_record, cfg, model)


# --------------------------------------------------------------------------
# The learner
# --------------------------------------------------------------------------

@dataclass
class TrainState:
    worlds: object
    buffer: dict  # tensors (buffer_len, n_envs, ...), circular over axis 0
    ptr: int  # next write slot of the circular buffer
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int  # learner steps taken
    mesh: object = None  # a parallel.Mesh: this state is one rank's block of the envs


def _masked_corr(x, y, m):
    m = m.to(torch.float32)
    n = m.sum() + 1e-6
    mx = (x * m).sum() / n
    my = (y * m).sum() / n
    cov = ((x - mx) * (y - my) * m).sum() / n
    vx = (torch.square(x - mx) * m).sum() / n
    vy = (torch.square(y - my) * m).sum() / n
    return cov / torch.sqrt(vx * vy + 1e-12)


def empty_buffer(cfg: TrainConfig, worlds):
    """The zeroed circular buffer: `cfg.buffer_len` slots of an
    `actor_record` record, shaped and typed from the worlds and config."""
    T, B = cfg.buffer_len, worlds.n_envs
    A, S = worlds.action_space.dim, worlds.n_seats
    dev = worlds.device
    bdt = getattr(torch, cfg.buffer_dtype)

    def zeros(shape, dtype):
        return torch.zeros((T,) + tuple(shape), dtype=dtype, device=dev)

    return {
        "worlds": _map_world(worlds, lambda x: zeros(x.shape, x.dtype)),
        "logits": zeros((B, A), bdt),
        "prior": zeros((B, A), bdt),
        "v": zeros((B, S), torch.float32),
        "n_leaves": zeros((B,), torch.int32),
        "terminal": zeros((B,), torch.bool),
        "rewards": zeros((B, S), torch.float32),
    }


def push(buffer, ptr, record):
    """Write one record into slot `ptr` of the buffer, in place."""
    for f in fields(record["worlds"]):
        getattr(buffer["worlds"], f.name)[ptr] = getattr(record["worlds"], f.name)
    for k, buf in buffer.items():
        if k != "worlds":
            buf[ptr] = record[k]


def ordered(tree, ptr):
    """Time-ordered copies, oldest to newest (slot ptr is the oldest), of a
    dict of buffer tensors. Only applied to the small leaves. The order is
    made on the host and copied to each leaf's device, which on a card
    waits for the device (`SYNC_ORDERED`, once a leaf)."""
    T = next(iter(tree.values())).shape[0]
    idx = (ptr + torch.arange(T)) % T
    count(SYNC_ORDERED, len(tree))
    return {k: x.index_select(0, idx.to(x.device)) for k, x in tree.items()}


def init(cfg: TrainConfig, model, draws: Draws, mesh=None):
    """A fresh train state: `init_worlds` from `draws`, a copy of `model`'s
    weights, its Adam optimizer and an empty buffer. On a mesh: the rank's
    block of the worlds (`draws` the sharded view), the weights and buffers
    broadcast from rank 0."""
    model = copy.deepcopy(model)
    worlds = init_worlds(cfg, draws, mesh)
    if mesh is not None:
        for t in (*model.parameters(), *model.buffers()):
            mesh.broadcast(t.data)
    return TrainState(worlds=worlds, buffer=empty_buffer(cfg, worlds), ptr=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()), step=0, mesh=mesh)


def warmup(cfg: TrainConfig, state: TrainState, draws: Draws):
    """Fill the buffer with `buffer_len` actor steps, no learning (reference
    main.py:174), in place."""
    _check_draws(draws, state.mesh)
    for _ in range(cfg.buffer_len):
        state.worlds, record = actor_record(cfg, state.model, state.worlds, draws,
                                            mesh=state.mesh)
        push(state.buffer, state.ptr, record)
        state.ptr = (state.ptr + 1) % cfg.buffer_len
    return state


def losses(model, batch):
    """(loss, aux, v): policy cross-entropy against the stored root policy
    plus the value MSE against reward-to-go, the learner telemetry and the
    network's (detached) values. The -inf logits of invalid actions are
    masked to 0; bf16 targets are upcast. The forward runs in train mode,
    the model's mode restored after it: batch norm takes the batch's
    statistics and moves its running ones."""
    worlds = batch["worlds"]
    was = model.training
    model.train()
    try:
        d = model(worlds.obs, worlds.valid, worlds.seats)
    finally:
        model.train(was)

    zeros = torch.zeros_like(d["logits"])
    l = torch.where(d["logits"] > -torch.inf, d["logits"], zeros)
    targets = batch["logits"].float()
    l0 = torch.where(targets > -torch.inf, targets, zeros)

    policy_loss = -(torch.exp(l0) * l).sum(-1).mean()
    target_v = batch["reward_to_go"]
    value_loss = torch.square(target_v - d["v"]).mean()
    loss = policy_loss + value_loss

    prior = batch["prior"].float()
    p0 = torch.where(prior > -torch.inf, prior, zeros)
    ld, vd = l.detach(), d["v"].detach()
    aux = {
        "loss.policy": policy_loss.detach(),
        "loss.value": value_loss.detach(),
        "resid-var.num": torch.square(target_v - vd).mean(),
        "resid-var.den": torch.square(target_v).mean(),
        "kl-div.behaviour": ((p0 - l0) * torch.exp(p0)).sum(-1).mean(),
        "kl-div.prior": ((p0 - ld) * torch.exp(p0)).sum(-1).mean(),
        "rel-entropy.policy": learning.rel_entropy(d["logits"].detach())[0],
        "rel-entropy.targets": learning.rel_entropy(targets)[0],
        "v.target.mean": target_v.mean(),
        "v.target.std": target_v.std(correction=0),
        "v.outputs.mean": vd.mean(),
        "v.outputs.std": vd.std(correction=0),
        "policy-conc": torch.exp(l0).max(-1).values.mean(),
    }
    return loss, aux, vd


# How the aux of the ranks' blocks make the whole batch's (`train_step` on a
# mesh): means over equal blocks average and counts add; the stds and the
# correlations are recomputed from global sums; grad.*, step.* and
# noise-scale are read from the reduced gradient and the replicated Adam
# state, so they are the whole batch's on every rank already.
_SUMMED = ("n-trajs", "wins.seat-0", "wins.seat-1")
_REPLICATED = ("grad.norm", "grad.max", "step.std", "step.max", "noise-scale")


def _global_aux(mesh, aux, spreads, corrs):
    """The whole batch's aux on every rank of `mesh`, from this rank's
    `aux` in two all-reduces. `spreads`: key -> this rank's values, whose
    std (correction 0) the key holds; `corrs`: key -> (x, y, m) of a
    `_masked_corr`. Sums travel in float64; each entry keeps its type."""
    own = set(_SUMMED) | set(_REPLICATED) | set(spreads) | set(corrs)
    means = [k for k in aux if k not in own]
    first = [aux[k] for k in means] + [aux[k] for k in _SUMMED]
    first += [x.sum() for x in spreads.values()]
    for x, y, m in corrs.values():
        m = m.to(torch.float32)
        first += [m.sum(), (x * m).sum(), (y * m).sum()]
    r1 = mesh.all_reduce(torch.stack([v.to(torch.float64) for v in first]))
    out = dict(aux)
    for i, k in enumerate(means):
        out[k] = (r1[i] / mesh.size).to(aux[k].dtype)
    for i, k in enumerate(_SUMMED, len(means)):
        out[k] = r1[i].to(aux[k].dtype)
    i = len(means) + len(_SUMMED)

    # second round: the squares about the global means
    second = []
    for x in spreads.values():
        mu = (r1[i] / (x.numel() * mesh.size)).to(x.dtype)
        second.append(torch.square(x - mu).sum())
        i += 1
    centres = []
    for x, y, m in corrs.values():
        m = m.to(torch.float32)
        n = r1[i] + 1e-6
        mx, my = (r1[i + 1] / n).to(x.dtype), (r1[i + 2] / n).to(y.dtype)
        second += [((x - mx) * (y - my) * m).sum(), (torch.square(x - mx) * m).sum(),
                   (torch.square(y - my) * m).sum()]
        centres.append(n)
        i += 3
    r2 = mesh.all_reduce(torch.stack([v.to(torch.float64) for v in second]))
    for j, (k, x) in enumerate(spreads.items()):
        out[k] = torch.sqrt(r2[j] / (x.numel() * mesh.size)).to(aux[k].dtype)
    j = len(spreads)
    for k, n in zip(corrs, centres):
        cov, vx, vy = r2[j] / n, r2[j + 1] / n, r2[j + 2] / n
        out[k] = (cov / torch.sqrt(vx * vy + 1e-12)).to(aux[k].dtype)
        j += 3
    return out


def train_step(cfg: TrainConfig, state: TrainState, draws: Draws):
    """One actor step and one learner step (reference main.py:171-198), in
    place. Returns (state, aux), aux a dict of 0-dim tensors on the state's
    device; nothing here waits for the device.

    On a mesh (`state.mesh`, `draws` its sharded view): the rank's block is
    searched, pushed and sampled, its gradient all-reduced (one flat
    buffer, averaged) before the Adam step, and the aux made the whole
    batch's (`_global_aux`). Each rank's train-mode batch norm normalises
    by its own block's statistics, as DDP without SyncBatchNorm does; the
    running statistics are then averaged over the ranks (one flat buffer),
    so every rank searches with the same ones. Over equal blocks that makes
    the first batch norm's running-mean update the whole batch's; a deeper
    one averages statistics of activations each rank normalised alone."""
    _check_draws(draws, state.mesh)
    with span(STEP, step=state.step):
        worlds, record = actor_record(cfg, state.model, state.worlds, draws, mesh=state.mesh)
        with span(LEARNER):
            aux = _learn(cfg, state, draws, record)
    state.worlds = worlds
    state.step += 1
    return state, aux


def _learn(cfg: TrainConfig, state: TrainState, draws: Draws, record):
    """`train_step`'s learner: push `record`, sample the batch, one Adam
    step; advances `state.ptr` and returns the aux."""
    mesh = state.mesh
    B, T = state.worlds.n_envs, cfg.buffer_len
    push(state.buffer, state.ptr, record)
    ptr = (state.ptr + 1) % T

    # value targets need only the small time-ordered leaves; the large ones
    # are gathered per sampled slot below
    osmall = ordered({k: state.buffer[k] for k in ("rewards", "v", "terminal")}, ptr)
    terminal = osmall["terminal"][..., None].expand(osmall["rewards"].shape)
    rtg = learning.reward_to_go(osmall["rewards"], osmall["v"], terminal)

    # one timestep per env (reference main.py:169), read from its raw slot
    t_idx = draws.slots(B, T).long()
    envs = torch.arange(B, device=t_idx.device)
    slot = (ptr + t_idx) % T
    batch = {k: x[slot, envs] for k, x in state.buffer.items() if k != "worlds"}
    batch["worlds"] = _map_world(state.buffer["worlds"], lambda x: x[slot, envs])
    batch["reward_to_go"] = rtg[t_idx, envs]

    params = list(state.model.parameters())
    before = [p.detach().clone() for p in params]
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux, v_out = losses(state.model, batch)
    loss.backward()
    gflat = torch.cat([p.grad.reshape(-1) for p in params])
    if mesh is not None:
        # the mean over the whole batch: equal blocks' means, averaged
        mesh.all_reduce(gflat).div_(mesh.size)
        for p, g in zip(params, gflat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))
        _average_buffers(mesh, state.model)
    state.optimizer.step()
    uflat = torch.cat([(p.detach() - b).reshape(-1) for p, b in zip(params, before)])

    # chunk telemetry (reference main.py:28-59)
    tb = osmall["terminal"][..., None]
    aux.update({
        "loss.total": loss.detach(),
        "grad.norm": torch.sqrt(torch.square(gflat).sum()),
        "grad.max": gflat.abs().max(),
        "step.std": torch.sqrt(torch.square(uflat).mean()),
        "step.max": uflat.abs().max(),
        "n-trajs": record["terminal"].sum(),
        "wins.seat-0": (record["rewards"][:, 0] == 1).sum(),
        "wins.seat-1": (record["rewards"][:, 1] == 1).sum(),
        "mcts-n-leaves": record["n_leaves"].float().mean(),
        "corr.terminal": _masked_corr(osmall["v"], osmall["rewards"], tb),
        "corr.penultimate": _masked_corr(osmall["v"][:-1], osmall["rewards"][1:], tb[1:]),
        "noise-scale": learning.noise_scale(cfg.n_envs, state.optimizer),
    })
    if mesh is not None:
        aux = _global_aux(
            mesh, aux, {"v.target.std": batch["reward_to_go"], "v.outputs.std": v_out},
            {"corr.terminal": (osmall["v"], osmall["rewards"], tb),
             "corr.penultimate": (osmall["v"][:-1], osmall["rewards"][1:], tb[1:])})
    state.ptr = ptr
    return aux


def _average_buffers(mesh, model):
    """The model's buffers (batch norm's running statistics) averaged over
    the ranks, in place; nothing for a network without buffers."""
    bufs = list(model.buffers())
    if not bufs:
        return
    flat = mesh.all_reduce(torch.cat([b.reshape(-1) for b in bufs])).div_(mesh.size)
    for b, x in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(x.view_as(b))


def make_train(cfg: TrainConfig, device=None, mesh=None):
    """The learner's parts for a config, as the JAX package's `make_train`
    returns them: ``(model, opt, init, warmup, train_step)``.

    `model` holds the initial weights, made on the CPU from `cfg.seed` and
    moved to `device`; `opt(params)` builds the Adam optimizer;
    ``init(draws) -> state``, ``warmup(state, draws) -> state`` and
    ``train_step(state, draws) -> (state, aux)`` update the state in place.
    With a `mesh` (`parallel.make_mesh`), on the rank's device, `init` makes
    the rank's part of the state from the sharded view of the draws
    (`Draws.shard`); warmup and train_step follow the state's mesh."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the rank's {mesh.device}")
        device = mesh.device
        local_envs(cfg, mesh)
    device = resolve_device(device)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed))
    return (model, partial(make_optimizer, cfg), partial(init, cfg, model, mesh=mesh),
            partial(warmup, cfg), partial(train_step, cfg))


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def state_dict(state: TrainState, cfg: TrainConfig):
    """The agent part of a checkpoint: the model's and the optimizer's state
    dicts, the step and the search's settings. It only references the live
    tensors; `pavlov.storage` copies them to the host when it writes."""
    return {
        "params": state.model.state_dict(),
        "opt": state.optimizer.state_dict(),
        "step": state.step,
        "kwargs": {"n_nodes": float(cfg.n_nodes), "c_puct": float(cfg.c_puct)},
    }


def load_state_dict(state: TrainState, sd) -> TrainState:
    """Load a checkpoint's agent part into `state` in place: the port's
    (`state_dict`), or the JAX package's, whose params are a flax tree and
    whose `opt` is the flat `jax.tree.leaves` list of its optax adam state
    (carried over by `models.convert`), which holds the FC network alone:
    for another network it raises ValueError."""
    if isinstance(sd["opt"], list):
        if not isinstance(state.model, FCModel):
            raise ValueError(f"a JAX checkpoint holds the FC network; this state's network is "
                             f"{type(state.model).__name__}")
        params = sd["params"]
        state.model.load_state_dict(convert.from_flax(params))
        convert.adam_from_optax(convert.adam_from_leaves(params, sd["opt"]), state.model,
                                state.optimizer)
    else:
        state.model.load_state_dict(sd["params"])
        state.optimizer.load_state_dict(sd["opt"])
    state.step = int(sd["step"])
    return state


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

# aux keys the loop writes as means (boardlaw_tpu/train.py's run loop)
MEAN_PREFIXES = ("loss", "corr", "kl", "rel-entropy", "v.", "policy-conc", "mcts", "noise",
                 "step.", "grad.", "resid")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_scalars(aux):
    """A dict of 0-dim tensors as Python floats, in one device-to-host
    transfer: the loop's one wait for the device a step."""
    keys = list(aux)
    values = torch.stack([aux[k].detach().reshape(()).to(torch.float64) for k in keys])
    count(SYNC_AUX)
    return dict(zip(keys, values.cpu().tolist()))


def run(boardsize, width, depth, desc="", nodes=64, c_puct=1 / 16, lr=1e-3, n_envs=32 * 1024,
        storer="time", max_steps=None, resume=None, arena=False, arena_ladder="rollout",
        n_devices=None, device=None, **overrides):
    """Train an agent; returns the run's name. The JAX package's `run`, with
    its signature and defaults, on one card (or where `device` says).

    The config is `make_config`'s (boards of 7 and up take the K=8 grow
    search). `max_steps` bounds the learner steps; `resume` (a run name,
    fragment or negative index) continues that run in place from its latest
    checkpoint: the weights, the Adam state and the step counter, the
    storer's sample/FLOP/time accounting seeded from it. As in the JAX
    package, a resumed run mixes fresh worlds and refills its buffer from
    `cfg.seed`'s draws. `arena=True` spawns the live arena
    (`arena.live.run`, with `arena_ladder` "rollout" or "external"), which
    evaluates the run's latest checkpoint on the same device while the run
    trains and is terminated when it ends.

    `n_devices=n > 1` trains data-parallel over n spawned ranks, rank r on
    card r (every rank on the CPU with `device="cpu"`), each holding
    `n_envs / n` envs (`parallel/`). Rank 0 alone makes the run directory
    and writes the log, the stats, the checkpoints and the storer's
    accounting, of the whole batch; it alone spawns the live arena. A
    resumed run loads the same checkpoint on every rank. Fewer visible cards
    than `n_devices`, or `n_envs` not divisible by it, raise ValueError."""
    cfg = make_config(boardsize, width, depth, nodes=nodes, c_puct=c_puct, lr=lr, n_envs=n_envs,
                      **overrides)
    setup = dict(desc=desc, storer=storer, max_steps=max_steps, resume=resume, arena=arena,
                 arena_ladder=arena_ladder)
    if n_devices is None or n_devices <= 1:
        return _train(cfg, device=resolve_device(device), **setup)
    from .parallel import distributed

    rank_device = _rank_device(n_devices, device)
    if cfg.n_envs % n_devices:
        raise ValueError(f"n_envs={cfg.n_envs} does not split over n_devices={n_devices}")
    if resume is not None:
        setup["resume"] = runs.resolve(resume)
    return distributed.launch(_train_rank, n_devices, device=rank_device, args=(cfg, setup))[0]


def _rank_device(n_devices, device):
    """`distributed.launch`'s device for `run`'s ranks: 'cpu', or None
    (rank r on card r) when enough cards are visible."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    if device is not None and torch.device(device) != torch.device("cuda"):
        raise ValueError(f"n_devices > 1 puts rank r on card r: device must be 'cuda' or "
                         f"'cpu', got {device!r}")
    visible = torch.cuda.device_count()
    if visible < n_devices:
        raise ValueError(f"n_devices={n_devices} needs {n_devices} cards; {visible} visible")
    return None


def _train_rank(mesh, cfg, setup):
    return _train(cfg, device=mesh.device, mesh=mesh, **setup)


def _train(cfg, desc, storer, max_steps, resume, arena, arena_ladder, device, mesh=None):
    """`run`'s loop in one process, or in one rank of a mesh (rank 0 keeps
    the run). Returns the run's name (None on the other ranks)."""
    main = mesh is None or mesh.rank == 0
    _, _, init_fn, warmup_fn, train_step_fn = make_train(cfg, device=device, mesh=mesh)
    draws = Draws(cfg.seed, device)
    if mesh is not None:
        draws = draws.shard(mesh.rank, mesh.size)

    t0 = time.perf_counter()
    state = init_fn(draws)
    _sync(device)
    init_s = time.perf_counter() - t0

    resumed_payload = run_name = None
    if resume is not None:
        run_name = runs.resolve(resume)
        resumed_payload = pstorage.load_latest(run_name)
        state = load_state_dict(state, resumed_payload["agent"])
        log.info(f"resumed {run_name} at step {state.step}")
    elif main:
        run_name = runs.new_run(description=desc, boardsize=cfg.boardsize, width=cfg.width,
                                depth=cfg.depth, nodes=cfg.n_nodes, c_puct=cfg.c_puct, lr=cfg.lr,
                                n_envs=cfg.n_envs)
        pstorage.save_raw(run_name, "model",
                          {"cfg": dict(cfg.__dict__), "kind": type(state.model).__name__})

    t0 = time.perf_counter()
    state = warmup_fn(state, draws)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    live = None
    if main:
        flops_per = bstorage.flops_per_sample(state.model, cfg.n_nodes)
        storer_cls = bstorage.TimeStorer if storer == "time" else bstorage.FlopsStorer
        storer = storer_cls(run_name, cfg.boardsize, flops_per)
        if resumed_payload is not None:
            # continue the sample/FLOP accounting: seed the counters from
            # the checkpoint and skip the savepoints the run already took
            storer.seed(n_flops=resumed_payload.get("n_flops", 0.0),
                        n_samples=resumed_payload.get("n_samples", 0.0),
                        runtime=resumed_payload.get("runtime", 0.0))
        if arena:
            from .arena import live as arena_live

            live = arena_live.run(run_name, ladder=arena_ladder, device=device)
    try:
        with ExitStack() as stack:
            if main:
                stack.enter_context(logs.to_run(run_name))
                stack.enter_context(stats.to_run(run_name))
                log.info(f"set-up: init (mix) {init_s:.3f} s, warmup {warmup_s:.3f} s")
                stats.last("time.setup.init", init_s)
                stats.last("time.setup.warmup", warmup_s)
            last = time.perf_counter()
            while True:
                state, aux = train_step_fn(state, draws)
                finished = max_steps is not None and state.step >= max_steps
                if main:
                    stored, last = _record_step(cfg, state, aux, storer, device, last)
                    finished = stored or finished
                if mesh is not None:  # rank 0's storer decides for every rank
                    flag = torch.tensor([int(finished)], dtype=torch.int32, device=device)
                    finished = bool(mesh.broadcast(flag).item())
                if finished:
                    if main:
                        # the full payload (n_flops/n_samples/runtime too), so
                        # a resumed run continues the accounting
                        pstorage.save_latest(run_name, storer.payload(state_dict(state, cfg)))
                    break
    finally:
        if live is not None:
            live.terminate()
            live.join()

    log.info("Finished")
    return run_name


def _record_step(cfg, state, aux, storer, device, last):
    """The loop's writes after a step: its aux as stats, the log line and
    the storer's step. Returns whether the storer has finished, and the
    time the step's clock stopped (the next one's start)."""
    aux = _host_scalars(aux)
    now = time.perf_counter()
    step_s = now - last
    with stats.defer():
        for k, v in aux.items():
            if k.startswith(MEAN_PREFIXES):
                stats.mean(k, v)
        # win fractions per finished trajectory
        n_trajs = max(aux["n-trajs"], 1.0)
        stats.mean("wins.seat-0", aux["wins.seat-0"], n_trajs)
        stats.mean("wins.seat-1", aux["wins.seat-1"], n_trajs)
        stats.rate("sample-rate.actor", cfg.n_envs)
        stats.rate("step-rate.learner", 1)
        stats.cumsum("count.samples", cfg.n_envs)
        stats.mean("n-trajs", aux["n-trajs"])
        stats.mean("time.step", step_s)
    pdevice.device(15, device)
    log.info(f"step {state.step}")
    return storer.step(state_dict(state, cfg), cfg.n_envs), now


def run_best(boardsize, **kwargs):
    """`run` with the best-known hyperparameters of `BEST` for a boardsize."""
    width, depth, nodes, c_puct = BEST[boardsize]
    return run(boardsize, width, depth, nodes=nodes, c_puct=c_puct, **kwargs)
