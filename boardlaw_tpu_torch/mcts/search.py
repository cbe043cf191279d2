"""Batched regularized-policy MCTS with the tree held as dense (B, T, ...)
tensors. Counterpart of boardlaw_tpu/mcts/search.py, for its two searches:

* K = 1 (`simulate`, the sequential reference search and the JAX package's
  default): each sim solves pi_bar(a) = lambda_N pi(a) / (alpha - q(a)) on
  every live node row and draws one action per node in the `node_actions`
  kernel, chases root->leaf in the `walk` kernel, expands one leaf and backs
  up: on the card in the `backup` kernel, on the CPU along the recorded path
  (`backup_path`). The tree's device alone picks the backup (`simulate`).
* K > 1 (`simulate_multi`): each pass runs, over its R node rows, the
  all-node solve and K inverse-CDF draws per node, the K*B root->leaf chases
  in the `walk` kernel, dedup of walks that halt at one edge, the Hex step
  and the network eval of the K*B leaf worlds, and one backup of the K paths:
  on the card in the `backup_prefix` kernel, on the CPU in torch ops
  (`backup_paths_prefix`), the tree's device alone picking, or by their
  spec `backup_paths` (`backup_mode` 'einsum'). With grow passes (the
  production search for boards of 7 and up) pass p covers the first
  R = 1 + (p+1)K rows; in scan mode every pass covers all T rows. The solve
  and draws run fused in the `node_actions_multi` kernel, or split: the solve
  by the `solve_probs` kernel (probs, or only the roots alpha), in torch ops,
  or warm-started in torch ops from the previous pass's roots; the draws by
  the `sample_children_multi` kernel or in torch ops (`MCTSConfig`).

The JAX package routes its row reads and writes through one-hot einsums and
blends, grows the tree by slicing and padding (`_slice_tree`, `_pad_tree`)
and chases with `lax.while_loop`s; all are TPU formulations. Here the tree is
allocated at its full T once, the kernels get the leading rows that can be
live as strided views (rows beyond them are still at their `build()` values,
exactly what the JAX package pads in), reads and writes are index gathers and
scatters, and chases are loops bounded by the tree's depth, with masks and no
host sync. The values are the same; the dataflow is not.

Every kernel samples in the log-shift prefix-sum order of the Pallas kernels
(the JAX `sample_cum='shift'` order), and so does the K=1 sampler, also
where the JAX package's XLA K=1 sampler `_sample` uses `jnp.cumsum`: the two
differ only where a uniform lies within roundoff of a CDF boundary. The K>1
torch sampler follows `sample_cum`, 'matmul' (the JAX default) or 'shift'.

Known-bug policy as in the JAX package: `backup_n='seats'` counts each
backup visit once per seat, as the reference implementation does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch
import torch.nn.functional as F

from . import kernels
from ..draws import Draws
from ..utils.profiling import span

# spans (utils.profiling): the root, a K>1 pass or a K=1 simulation, and
# the parts of each
ROOT = "search.root"
PASS = "search.pass"
SIM = "search.sim"
SOLVE = "search.solve"
WALK = "search.walk"
EXPAND = "search.expand"
EVAL = "search.eval"
BACKUP = "search.backup"


@dataclass(frozen=True)
class MCTSConfig:
    """Search configuration of the port. The defaults are the JAX package's:
    K=1, the sequential search.

    The knobs that describe only TPU dataflow are not carried: the
    `pallas_*` switches and block sizes, `use_pallas`, `write_mode`,
    `gather_mode`, `mesh_axis` and `compact` (JAX's switch to the
    wide types at every tree size, which no caller turns off). The port runs
    its kernels on the card.

    `mesh` (a `parallel.Mesh`, None in one process) makes the search one
    rank's part of a data-parallel search over its block of the envs: the
    tree records it, and `_q_bounds`, the search's one whole-batch
    reduction, all-reduces over it. The kernels run on the rank's block
    with the global bounds, as JAX's `shard_map` runs them per shard. Its kernels sample with the log-shift prefix
    sum (the JAX `sample_cum='shift'` order); the K>1 torch sampler follows
    `sample_cum`.

    The tree's bookkeeping types follow JAX's rule for its default
    `compact=True` (`tree_dtypes`): int8 children while the tree has at
    most 127 node slots, else int32; bf16 edge counts while 2T <= 256
    (every count, even counted once per seat, is then exact in bf16), else
    float32. Every kernel has an instantiation for each pair the rule
    gives: (int8, bf16), (int32, bf16) at T = 128, and (int32, float32).

    `tree_dtype` is the storage type of the tree's logits, torch.float32 or
    torch.bfloat16 (the JAX flagship's): every write rounds into it, every
    solve reads it widened to float32 (the row kernels at their loads). In
    bf16 the -inf proxy -1e4 is stored as -9984, and `root()`'s prior holds
    -9984 at invalid actions where float32 gives -inf, as in JAX.

    Two pick the solve and sampler of the K>1 `simulate_multi`:

    * `solve_kernel`: 'fused' solves and draws in the `node_actions_multi`
      kernel (JAX `pallas_nodes=True`); the split routes solve in torch ops
      ('ops', JAX's XLA `node_probs`), in the `solve_probs` kernel ('probs',
      JAX `pallas_solve=True`), or take only its roots alpha and evaluate
      the probs in torch ops ('alpha', JAX `pallas_solve="alpha"`).
      `warm_solve` warm-starts the torch solve and needs 'ops': in JAX the
      warm solve takes precedence over the solve kernel.
    * `sample_kernel`, read only on the split routes: draw in the
      `sample_children_multi` kernel (JAX `pallas_sample=True`), else in
      torch ops in the `sample_cum` order.

    Invalid combinations raise a ValueError.
    """

    n_nodes: int = 64
    c_puct: float = 1 / 16
    noise_eps: float = 0.25
    alpha_scale: float = 10.0
    backup_n: str = "seats"  # 'seats' = reference behaviour, 'visits' = fixed
    leaves_per_pass: int = 1
    solve_iters: int = 6  # K>1 solve budget; K=1 always runs 16 Newton steps
    solve_accel: bool = True  # K>1 only, as solve_iters
    warm_solve: bool = False
    sample_cum: str = "matmul"  # K>1 torch sampler: 'matmul' or 'shift'
    grow_passes: bool = False
    backup_mode: str = "prefix"  # K>1: 'prefix', or its spec 'einsum'
    solve_kernel: str = "fused"
    sample_kernel: bool = False
    tree_dtype: torch.dtype = torch.float32
    mesh: object = None

    def __post_init__(self):
        if self.leaves_per_pass < 1:
            raise ValueError(f"leaves_per_pass must be >= 1, got {self.leaves_per_pass}")
        for name, allowed in (("backup_mode", ("prefix", "einsum")),
                              ("sample_cum", ("matmul", "shift")),
                              ("solve_kernel", ("fused", "ops", "probs", "alpha"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        if self.warm_solve and self.solve_kernel != "ops":
            raise ValueError(f"warm_solve warm-starts the torch solve: it needs "
                             f"solve_kernel='ops', got {self.solve_kernel!r}")
        if self.tree_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"tree_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {self.tree_dtype}")
        if self.backup_n not in ("seats", "visits"):
            raise ValueError(f"backup_n must be 'seats' or 'visits', got {self.backup_n!r}")

    @property
    def n_passes(self):
        return -(-(self.n_nodes - 1) // self.leaves_per_pass)


def tree_size(cfg):
    """Node slots: K per pass plus the root (n_nodes at K=1)."""
    return 1 + cfg.leaves_per_pass * (-(-(cfg.n_nodes - 1) // cfg.leaves_per_pass))


def tree_dtypes(cfg):
    """(children, n_edge) storage types of `cfg`'s tree, by JAX's rule
    (`build` there, with its default `compact=True`)."""
    T = tree_size(cfg)
    children = torch.int8 if T <= 127 else torch.int32
    counts = torch.bfloat16 if 2 * T <= 256 else torch.float32
    return children, counts


@dataclass
class Tree:
    """The search tree of every env. Edge statistics mirror child node
    statistics: n_edge[b,p,a] == n[b,c] and w_edge[b,p,a] == w[b,c,seat(p)]
    for the edge (p, a) -> c."""

    children: torch.Tensor  # (B,T,A) int8 or int32 (`tree_dtypes`), -1 = unexpanded
    parents: torch.Tensor  # (B,T) int32, -1 = no parent
    relation: torch.Tensor  # (B,T) int32, action that led here
    worlds: object  # world dataclass with fields (B,T,...)
    seats: torch.Tensor  # (B,T) int32 seat to play per node
    terminal: torch.Tensor  # (B,T) bool
    rewards: torch.Tensor  # (B,T,S) f32
    logits: torch.Tensor  # (B,T,A) tree_dtype log-prior per node (clamped)
    v: torch.Tensor  # (B,T,S) f32 network value per node
    n: torch.Tensor  # (B,T) int32 visit counts
    w: torch.Tensor  # (B,T,S) f32 value sums
    n_edge: torch.Tensor  # (B,T,A) bf16 (exact up to 256) or f32 visits of each child
    w_edge: torch.Tensor  # (B,T,A) f32 child value sums for the parent's seat
    c_puct: torch.Tensor  # (B,) f32
    sim: int  # next free node slot
    prew: torch.Tensor | None  # (B,T,S) f32 cumulative rewards root->node inclusive (K>1 prefix)
    alpha: torch.Tensor | None = None  # (B,T) f32 the last pass's roots (K>1 warm_solve)
    mesh: object = None  # the data-parallel world the bounds reduce over (MCTSConfig.mesh)


def _map_world(world, fn):
    return replace(world, **{f.name: fn(getattr(world, f.name)) for f in fields(world)})


def build(world, cfg: MCTSConfig):
    """Preallocate the tree at its full T with the root world in slot 0."""
    B = world.n_envs
    T = tree_size(cfg)
    A = world.action_space.dim
    S = world.n_seats
    dev = world.device
    f32 = torch.float32
    K = cfg.leaves_per_pass
    child_dtype, count_dtype = tree_dtypes(cfg)

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return Tree(
        children=full((B, T, A), -1, child_dtype),
        parents=full((B, T), -1, torch.int32),
        relation=full((B, T), -1, torch.int32),
        worlds=_map_world(world, lambda x: x[:, None].expand((B, T) + x.shape[1:]).clone()),
        seats=world.seats.to(torch.int32)[:, None].expand(B, T).clone(),
        terminal=zeros(B, T, dtype=torch.bool),
        rewards=zeros(B, T, S),
        logits=zeros(B, T, A, dtype=cfg.tree_dtype),
        v=zeros(B, T, S),
        n=zeros(B, T, dtype=torch.int32),
        w=zeros(B, T, S),
        n_edge=zeros(B, T, A, dtype=count_dtype),
        w_edge=zeros(B, T, A),
        c_puct=full((B,), cfg.c_puct, f32),
        sim=0,
        prew=zeros(B, T, S) if K > 1 and cfg.backup_mode == "prefix" else None,
        # zeros fail the warm gate (0 <= floor): the first pass starts cold
        alpha=zeros(B, T) if K > 1 and cfg.warm_solve else None,
        mesh=cfg.mesh,
    )


# Finite stand-in for -inf inside tree tensors: exp(-1e4) underflows to 0.
# bf16 tree logits store it as -9984, above the proxy, so `_unclamp_logits`
# leaves it finite there (as the JAX package does).
NEG_INF_PROXY = -1e4


def _clamp_logits(logits):
    return torch.clamp_min(logits, NEG_INF_PROXY)


def _unclamp_logits(logits):
    return torch.where(logits <= NEG_INF_PROXY, -torch.inf, logits)


def _log_gamma_fixed(a, normals, uniforms, boost_uniforms):
    """log of a Gamma(a) draw by fixed-round Marsaglia-Tsang rejection: the
    first accepted of `rounds` proposals (normals/uniforms (rounds, *shape)),
    the mode d where none accepts; for a < 1 the draw for a+1 is boosted by
    u**(1/a), in log space."""
    boost = a < 1.0
    ab = a + 1.0 if boost else float(a)
    d = ab - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = normals
    base = 1.0 + c * x
    v = base * base * base
    logv = torch.log(torch.where(v > 0, v, 1.0))
    ok = (v > 0) & (torch.log(uniforms) < 0.5 * x * x + d - d * v + d * logv)
    idx = torch.argmax(ok.to(torch.int32), 0)
    picked = torch.gather(logv, 0, idx[None])[0]
    log_g = math.log(d) + torch.where(ok.any(0), picked, 0.0)
    if boost:
        log_g = log_g + torch.log(boost_uniforms) / a
    return log_g


def dirichlet_noise(logits, valid, eps, alpha_scale, draws: Draws, rounds=4):
    """Mix a symmetric-Dirichlet draw over the valid actions into the root
    prior; the draw is normalised gammas sampled in log space."""
    A = logits.shape[-1]
    normals, uniforms, boost = draws.dirichlet(logits.shape, rounds)
    log_g = _log_gamma_fixed(alpha_scale / A, normals, uniforms, boost)
    log_g = torch.where(valid, log_g, -torch.inf)
    draw = torch.exp(log_g - log_g.max(-1, keepdim=True).values)
    draw = draw / draw.sum(-1, keepdim=True)
    probs = torch.exp(logits.float()) * (1 - eps) + draw * eps
    return torch.log(probs)


def initialize(tree, decisions, draws, cfg: MCTSConfig, valid):
    """Seed the root with the network eval plus Dirichlet exploration noise."""
    noised = dirichlet_noise(decisions["logits"], valid, cfg.noise_eps, cfg.alpha_scale, draws)
    tree.logits[:, 0] = _clamp_logits(noised)
    tree.v[:, 0] = decisions["v"]
    tree.sim = 1
    return tree


# --------------------------------------------------------------------------
# The regularized-policy solve and the sampler (plain versions; the
# node_actions and node_actions_multi kernels compute both in one pass)
# --------------------------------------------------------------------------

def solve_policy(pi, q, lambda_n, tol=1e-3, n_iters=16, warm_alpha=None, return_alpha=False,
                 accel=False, return_steps=False):
    """Solve pi_bar(a) = lambda_n*pi(a)/(alpha - q(a)) for alpha with
    sum_a pi_bar = 1, over rows. pi, q (R,A); lambda_n (R,).

    A fixed number of steps with frozen rows once converged. Newton with the
    one-sided err < tol test, or with `accel` safeguarded-Halley steps (the
    Newton step times 1/(1-t), t = err*s''/(2 s'^2), only from below the
    root and while t < 0.75, the factor capped at 4) with the two-sided
    |err| < tol test.

    `warm_alpha` (R,) restarts from an earlier solve's roots: kept where it
    is above the floor and still below the new root (s(warm) > 1), and not
    below the cold start; elsewhere the cold start.

    `return_steps` also returns each row's steps (R,) int32: the step in
    which its test first holds (counted from 1), else n_iters; later steps
    leave its alpha as it is."""
    lam = lambda_n[:, None].float()
    pi = pi.float()
    q = q.float()

    lampi = lam * pi
    gap = torch.clamp_min(lampi, 1e-4)
    alpha = (q + gap).max(-1).values
    floor = q.max(-1).values + 1e-6
    if warm_alpha is not None:
        warm_alpha = warm_alpha.float()
        s_w = (lampi / (warm_alpha[:, None] - q)).sum(-1)
        ok = (warm_alpha > floor) & (s_w > 1.0)
        alpha = torch.where(ok, torch.maximum(warm_alpha, alpha), alpha)
    done = torch.zeros(alpha.shape, dtype=torch.bool, device=alpha.device)
    steps = torch.zeros_like(alpha, dtype=torch.int32) if return_steps else None

    for _ in range(n_iters):
        if return_steps:
            steps += ~done
        r = 1.0 / (alpha[:, None] - q)
        terms = lampi * r
        s = terms.sum(-1)
        g = -(terms * r).sum(-1)
        err = s - 1.0
        step = err / g
        if accel:
            done = done | (err.abs() < tol)
            h = 2.0 * (terms * r * r).sum(-1)
            t = err * h / (2.0 * g * g)
            ok = (err > 0) & (t < 0.75)
            step = torch.where(ok, step / torch.clamp_min(1.0 - t, 0.25), step)
        else:
            done = done | (err < tol)
        alpha = torch.maximum(alpha - torch.where(done, 0.0, step), floor)

    probs = lampi / (alpha[:, None] - q)
    if return_steps:
        return probs, alpha, steps
    return (probs, alpha) if return_alpha else probs


def _edge_q_counts(n_edge, w_edge, q_bounds):
    """q in [0,1] on expanded edges (0 elsewhere) and the visit counts
    (1 for unexpanded edges) of a node row."""
    lo, hi = q_bounds[0], q_bounds[1]
    ne = n_edge.float()
    we = w_edge.float()
    expanded = ne > 0
    q = torch.where(expanded, (we / (ne + 1e-4) - lo) / (hi - lo + 1e-4), 0.0)
    counts = torch.where(expanded, ne, 1.0)
    return q, counts


def _rows(x, t):
    """Per-env node rows x[b, t[b]] of a (B,T,...) tensor; t an int or (B,)."""
    if isinstance(t, int):
        return x[:, t]
    return x[torch.arange(x.shape[0], device=x.device), t.long()]


def _node_policy(tree, t, q_bounds):
    """pi_bar of node row t (an int, or (B,) per-env rows) of every env, by
    the 16-step Newton solve."""
    rows = [_rows(x, t)[:, None] for x in (tree.logits, tree.n_edge, tree.w_edge)]
    return node_probs(*rows, tree.c_puct, q_bounds)[:, 0]


def _q_bounds(tree):
    """Global (min, max) of the per-(node, seat) q estimates w/n over all
    envs, as a (2,) tensor on the tree's device. Rows beyond a pass's R hold
    zeros, as do its unwritten rows, so the full tree gives the bounds of
    the first R rows. On a rank of a mesh (`tree.mesh`) the envs are every
    rank's: one all-reduce MAX of (-min, max)."""
    q = tree.w / (tree.n[..., None].float() + 1e-4)
    if tree.mesh is None:
        return torch.stack([q.min(), q.max()])
    b = tree.mesh.all_reduce(torch.stack([-q.min(), q.max()]), "max")
    return torch.stack([-b[0], b[1]])


def node_probs(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=16, accel=False,
               return_alpha=False, warm_alpha=None, fixed_alpha=None):
    """Solved pi_bar for every node row: (B,T,A) tensors -> (B,T,A) f32
    (and the (B,T) alphas with `return_alpha`).

    `warm_alpha` (B,T) warm-starts the solve (`solve_policy`);
    `fixed_alpha` (B,T) skips it and evaluates lam*pi/(alpha - q) at the
    given roots (the `solve_probs` kernel's alpha output)."""
    B, T, A = logits.shape
    q, counts = _edge_q_counts(n_edge, w_edge, q_bounds)
    pi = torch.exp(logits.float())
    N = counts.sum(-1)
    lam = c_puct[:, None] * N / (N + A)
    if fixed_alpha is not None:
        return (lam[:, :, None] * pi) / (fixed_alpha[:, :, None].float() - q)
    if warm_alpha is not None:
        warm_alpha = warm_alpha.reshape(B * T)
    probs, alpha = solve_policy(pi.reshape(B * T, A), q.reshape(B * T, A), lam.reshape(B * T),
                                n_iters=n_iters, accel=accel, return_alpha=True,
                                warm_alpha=warm_alpha)
    probs = probs.reshape(B, T, A)
    return (probs, alpha.reshape(B, T)) if return_alpha else probs


def _shift_cumsum(probs):
    """Inclusive prefix sum over the last axis in the log-shift
    (Hillis-Steele) order of the Pallas kernels and the JAX package's
    `cum_mode='shift'`."""
    A = probs.shape[-1]
    cum = probs
    shift = 1
    while shift < A:
        cum = cum + F.pad(cum, (shift, 0))[..., :A]
        shift *= 2
    return cum


def _draw(probs, cum, rand):
    """Inverse-CDF draw over the last axis: the first lane with prob > 0 and
    cum >= rand, else the last positive lane (-1 when a row has none)."""
    A = probs.shape[-1]
    lane = torch.arange(A, device=probs.device)
    pos = probs > 0
    last_pos = torch.where(pos, lane, -1).max(-1).values
    big = A + 1
    first = torch.where(pos & (cum >= rand[..., None]), lane, big).min(-1).values
    return torch.where(first < big, first, last_pos).to(torch.int32)


def _sample(probs, rand):
    """One draw per row: probs (..., A), rand (...) -> (...) int32."""
    return _draw(probs, _shift_cumsum(probs), rand)


def _sample_children_multi(children, probs, rands, cum_mode="shift"):
    """K draws per node from solved probs (B,T,A) with rands (K,B,T) ->
    (actions, child) (K,B,T) int32, child 0 where a row has no positive
    lane; the prefix sum is taken once for all K draws.

    cum_mode 'shift': the log-shift sum and "first positive lane with
    cum >= r, else the last positive lane", bit-equal to the sampler
    kernels. 'matmul' (the JAX default): the inclusive sum as one f32
    product with the (A,A) upper-triangular ones (TF32 off, as JAX's
    Precision.HIGHEST), and each draw as the count clip(#{cum < r},
    first_pos, last_pos), the same draw up to the sums' roundoff. Draws
    run one k at a time, so no (K,B,T,A) tensor is made."""
    if cum_mode == "shift":
        cum = _shift_cumsum(probs)
    else:
        A = probs.shape[-1]
        lane = torch.arange(A, device=probs.device)
        pos = probs > 0
        first_pos = torch.where(pos, lane, A).min(-1).values
        last_pos = torch.where(pos, lane, -1).max(-1).values
        # full f32 while torch.backends.cuda.matmul.allow_tf32 is False (the
        # default, which FCModel also sets)
        cum = torch.matmul(probs.float(), (lane[:, None] <= lane[None, :]).float())
    acts, childs = [], []
    for k in range(rands.shape[0]):
        if cum_mode == "shift":
            a_k = _draw(probs, cum, rands[k])
        else:
            cnt = (cum < rands[k][..., None]).sum(-1)
            a_k = torch.minimum(torch.maximum(cnt, first_pos), last_pos).to(torch.int32)
        c_k = torch.gather(children, -1, a_k.clamp_min(0)[..., None].long())[..., 0]
        acts.append(a_k)
        childs.append(torch.where(a_k >= 0, c_k.to(torch.int32), 0))
    return torch.stack(acts), torch.stack(childs)


def _sample_children(children, probs, rands):
    """One draw per node, rands (B,T) -> (actions, child) (B,T) int32."""
    acts, childs = _sample_children_multi(children, probs, rands[None])
    return acts[0], childs[0]


def node_actions(logits, n_edge, w_edge, children, rands, c_puct, q_bounds):
    """The K=1 all-node pass: every node row's 16-step Newton solve (the
    one-sided err < 1e-3 test, no acceleration) and one draw per node with
    rands (B,T). (B,T,A) tree tensors -> (actions, child) (B,T) int32.

    Each node has its own pre-drawn uniform (reference mcts/cpp/cuda.cu:
    184-203), so a node's action does not depend on where the walk is and
    all rows can be solved at once."""
    probs = node_probs(logits, n_edge, w_edge, c_puct, q_bounds)
    return _sample_children(children, probs, rands)


def _walk(acts, nxt, halt, root_terminal, max_levels=None):
    """Root->leaf pointer chase over (N,T) rows, level by level.

    Node ids strictly increase along a path, so T levels bound every walk;
    `max_levels` caps it tighter. Returns (parents, actions, halt_child,
    path) with path (N,L) the visited node per level, -1 past the halting
    depth; the halting leaf itself is not recorded."""
    N, T = acts.shape
    L = T if max_levels is None else min(T, max_levels)
    dev = acts.device
    t = torch.zeros((N,), dtype=torch.int64, device=dev)
    active = ~root_terminal
    parents = torch.zeros((N,), dtype=torch.int32, device=dev)
    actions = torch.full((N,), -1, dtype=torch.int32, device=dev)
    halt_child = torch.full((N,), -1, dtype=torch.int32, device=dev)
    levels = []
    for _ in range(L):
        a_t = torch.gather(acts, 1, t[:, None])[:, 0]
        c_t = torch.gather(nxt, 1, t[:, None])[:, 0]
        h_t = torch.gather(halt, 1, t[:, None])[:, 0]
        t32 = t.to(torch.int32)
        parents = torch.where(active, t32, parents)
        actions = torch.where(active, a_t.to(torch.int32), actions)
        levels.append(torch.where(active, t32, -1))
        newly = active & h_t
        halt_child = torch.where(newly, c_t.to(torch.int32), halt_child)
        active = active & ~h_t
        t = torch.where(active, c_t.long(), t)
    return parents, actions, halt_child, torch.stack(levels, 1)


def _node_actions_any(tree, rands):
    """acts, nxt (B,R) of the R = tree.sim live node rows, from the
    `node_actions` kernel (its twin on the CPU); rands (B,T). Rows at and
    beyond `sim` are unreachable: every child pointer is below it."""
    R = tree.sim
    return kernels.node_actions(
        tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R], tree.children[:, :R],
        rands[:, :R].contiguous(), tree.c_puct, _q_bounds(tree))


def _walk_any(tree, acts, nxt):
    """The `walk` kernel over the R live rows: node ids strictly increase
    along a path, so R levels bound every walk."""
    R = acts.shape[1]
    return kernels.walk(tree.terminal[:, :R], acts, nxt, max_levels=R)


def descend(tree, rands):
    """Walk each env's tree from the root until the sampled child is
    unexpanded or terminal -> (parents, actions) (B,) int32: the node to
    expand from and the action taken. All per-node work is the one
    `node_actions` pass, the chase is `walk`; equal to `descend_reference`
    and to the `descend` kernel."""
    acts, nxt = _node_actions_any(tree, rands)
    parents, actions, _, _ = _walk_any(tree, acts, nxt)
    return parents, actions


def descend_reference(tree, rands):
    """Level-serial walk: at each visited node solve its row, draw with
    rands[b, t] and step to the child, until the child is unexpanded or
    terminal. The executable spec of `descend` and the plain twin of the
    `descend` kernel. A loop of tree.sim masked levels (paths only visit
    live rows), with no host sync."""
    B, T, A = tree.children.shape
    qb = _q_bounds(tree)
    b = torch.arange(B, device=rands.device)
    t = torch.zeros((B,), dtype=torch.long, device=rands.device)
    parents = torch.zeros((B,), dtype=torch.int32, device=rands.device)
    actions = torch.full((B,), -1, dtype=torch.int32, device=rands.device)
    active = ~tree.terminal[:, 0]
    for _ in range(min(T, tree.sim)):
        a = _sample(_node_policy(tree, t, qb), rands[b, t])
        child = torch.where(a >= 0, tree.children[b, t, a.long().clamp_min(0)].long(), 0)
        parents = torch.where(active, t.to(torch.int32), parents)
        actions = torch.where(active, a, actions)
        active = active & (child >= 0) & ~tree.terminal[b, child.clamp_min(0)]
        t = torch.where(active, child, t)
    return parents, actions


# --------------------------------------------------------------------------
# Backup
# --------------------------------------------------------------------------

def backup(tree, leaves, n_per_visit, edge="seat"):
    """Propagate each env's leaf value to the root in place, zeroing it at
    terminal nodes and adding each node's rewards on the way (reference
    mcts/cpp/cuda.cu:205-236), then mirror the node deltas onto the parent
    edges (`_apply_deltas`). The plain twin of the `backup` kernel, and
    with `edge="dense"` of the `backup_dense` kernel.

    n_per_visit: what each visit adds to n; n_seats is the reference's
    per-seat increment, 1 the fix. `edge` is the rule for an edge's value:
    "seat", the value at the parent's seat clamped to [0, S-1] (the Pallas
    `backup`); "dense", the value at seat 0 where the parent's seat is 0
    and at seat S-1 otherwise (the Pallas `backup_dense`). The two agree
    for one and two seats. The chase is a loop of tree.sim masked levels
    (node ids strictly decrease towards the root and every leaf is below
    `sim`), not a `while any(active)` with a host sync per level."""
    B, T, S = tree.w.shape
    dev = tree.w.device
    b = torch.arange(B, device=dev)
    cur = leaves.long()
    v = tree.v[b, cur]
    dn = torch.zeros((B, T), dtype=torch.float32, device=dev)
    dw = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    for _ in range(min(T, tree.sim)):
        active = cur >= 0
        safe = cur.clamp_min(0)
        v = torch.where((tree.terminal[b, safe] & active)[:, None], 0.0, v)
        v = v + torch.where(active[:, None], tree.rewards[b, safe], 0.0)
        # a path visits each node once, so these row updates do not collide
        dn[b, safe] += torch.where(active, float(n_per_visit), 0.0)
        dw[b, safe] += torch.where(active[:, None], v, 0.0)
        cur = torch.where(active, tree.parents[b, safe].long(), -1)
    return _apply_deltas(tree, dn, dw, edge)


def _apply_deltas(tree, dn, dw, edge="seat"):
    """Fold the node deltas dn (B,T), dw (B,T,S) into the node stats and
    route them onto the parent edges, in place: an edge's stats are its
    child's, so n_edge[p(c), rel(c)] += dn[c] and w_edge[p(c), rel(c)] +=
    dw[c, seat(p(c))], the seat read by `backup`'s `edge` rule."""
    B, T, S = tree.w.shape
    has_edge = tree.parents >= 0
    safe_p = tree.parents.clamp_min(0).long()
    safe_r = tree.relation.clamp_min(0).long()
    seat_p = torch.gather(tree.seats, 1, safe_p).long()
    if edge == "dense":
        seat_p = torch.where(seat_p == 0, 0, S - 1)
    else:
        seat_p = seat_p.clamp(0, S - 1)
    dw_parent = torch.gather(dw, 2, seat_p[..., None])[..., 0]
    b = torch.arange(B, device=dn.device)[:, None].expand(B, T)
    # rows without an edge add 0 at (b, 0, 0): accumulate, not overwrite
    tree.n_edge.index_put_((b, safe_p, safe_r),
                           torch.where(has_edge, dn, 0.0).to(tree.n_edge.dtype), accumulate=True)
    tree.w_edge.index_put_((b, safe_p, safe_r), torch.where(has_edge, dw_parent, 0.0),
                           accumulate=True)
    tree.n += torch.round(dn).to(tree.n.dtype)
    tree.w += dw
    return tree


def _path_deltas(tree, path, acts, leaves, n_per_visit):
    """The stat deltas of backing up one recorded root->leaf path per env,
    as per-position entries. path (B,L) the walk's interior nodes (-1 past
    its depth), acts (B,R) the sampled action of each node row, leaves (B,).

    Returns (nodes (B,L+1) the path with the leaf at position depth(b), -1
    beyond; dn (B,L+1); dw (B,L+1,S); edge_a (B,L) the action taken at each
    interior node; edge_w (B,L) the child's value at that node's seat).

    Interior nodes are never terminal (the walk only steps into non-terminal
    children), so the value backed up at position l is the leaf's value
    (0 if terminal) plus the rewards of positions >= l: a reverse inclusive
    cumsum, added leaf-first as `backup` adds them."""
    B, L = path.shape
    S = tree.w.shape[-1]
    dev = path.device
    b = torch.arange(B, device=dev)
    depth = (path >= 0).sum(1)
    nodes = torch.cat([path, torch.full((B, 1), -1, dtype=path.dtype, device=dev)], 1)
    nodes[b, depth] = leaves.to(nodes.dtype)
    on = nodes >= 0
    safe = nodes.clamp_min(0).long()
    ll = leaves.long()
    base = torch.where(tree.terminal[b, ll][:, None], 0.0, tree.v[b, ll])
    x = torch.where(on[..., None], tree.rewards[b[:, None], safe], 0.0)
    x[b, depth] += base
    dw = torch.where(on[..., None], x.flip(1).cumsum(1).flip(1), 0.0)
    dn = on.to(torch.float32) * n_per_visit

    parent = safe[:, :L]
    edge_on = on[:, 1:]
    # a new leaf (slot `sim`, past acts' rows) can sit at a parent position;
    # it has no edge below it, so its clamped lookup is masked off
    edge_a = torch.gather(acts, 1, parent.clamp_max(acts.shape[1] - 1))
    seat = tree.seats[b[:, None], parent].long().clamp(0, S - 1)
    edge_w = torch.gather(dw[:, 1:], 2, seat[..., None])[..., 0]
    return nodes, dn, dw, torch.where(edge_on, edge_a, 0), torch.where(edge_on, edge_w, 0.0)


def _apply_path_deltas(tree, nodes, dn, dw, edge_a, edge_w):
    """Scatter `_path_deltas`' entries into the tree in place; an edge gets
    its child's dn. Masked positions add 0 at node 0 / edge (0, 0), so the
    scatters accumulate."""
    B, L1 = nodes.shape
    L = L1 - 1
    b = torch.arange(B, device=nodes.device)[:, None]
    safe = nodes.clamp_min(0).long()
    tree.n.index_put_((b.expand(B, L1), safe), torch.round(dn).to(tree.n.dtype), accumulate=True)
    tree.w.index_put_((b.expand(B, L1), safe), dw, accumulate=True)
    idx = (b.expand(B, L), safe[:, :L], edge_a.long())
    tree.n_edge.index_put_(idx, dn[:, 1:].to(tree.n_edge.dtype), accumulate=True)
    tree.w_edge.index_put_(idx, edge_w, accumulate=True)
    return tree


def backup_path(tree, path, acts, leaves, n_per_visit):
    """`backup`, along the path the walk recorded instead of re-chasing
    parent pointers: the same results, n/n_edge exact and w/w_edge to
    float32 roundoff (the suffix sums are a cumsum), with no loop."""
    return _apply_path_deltas(tree, *_path_deltas(tree, path, acts, leaves, n_per_visit))


def backup_paths(tree, paths, acts, leaves, n_per_visit):
    """Back up K recorded paths per env, in place: the executable spec of
    `backup_paths_prefix` (the JAX package's `backup_mode='einsum'`). paths
    (K,B,L) interior nodes (-1 padded), acts (K,B,R) the sampled actions,
    leaves (K,B).

    Each path's deltas are `backup_path`'s. They read only the tree's v,
    terminal, rewards and seats, never the statistics they update, so every
    path takes them from the pre-pass tree and adding them one path after
    another sums them, as the JAX package's path one-hot contractions do:
    n/n_edge exact and w/w_edge to float32 roundoff."""
    for k in range(paths.shape[0]):
        backup_path(tree, paths[k], acts[k], leaves[k], n_per_visit)
    return tree


def backup_paths_prefix(tree, paths, acts, leaves, n_per_visit):
    """Back up K recorded paths per env through the cumulative-reward
    prefix identity, in place. paths (K,B,L) interior nodes (-1 padded),
    acts (K,B,T) the sampled actions, leaves (K,B).

    With P = tree.prew and C_k = (leaf value, 0 if terminal) + P[leaf_k], the
    value backed up at path node t is C_k - (P[t] - rew[t]), so

      dn[t]     = npv * #{k : t on path k or t = leaf_k}
      dw[t]     = sum_k [t on path k or leaf_k] C_k - cnt(t) (P[t] - rew[t])
      d_ne[t,a] = npv * #{k : t on path k, acts[k,t] = a}
      d_we[t,a] = sum_k [t on path k, acts[k,t] = a] (C_k - P[t])[seat(t)]

    The sums are scatter-adds of the K*B*L path entries, not the JAX
    package's (K,B,T,A) compare-accumulate: the same values, n/n_edge exact
    and w/w_edge to float32 roundoff. The plain twin of the `backup_prefix`
    kernel, which makes its adds in the order and association they take on
    the card (on the CPU w_edge takes each walk's term in turn, on the card
    their sum)."""
    K, B, L = paths.shape
    dev = paths.device
    f32 = torch.float32
    b_k = torch.arange(B, device=dev)[None, :].expand(K, B)
    b_kl = b_k[:, :, None].expand(K, B, L)
    on = paths >= 0
    t_path = paths.clamp_min(0).long()
    ll = leaves.long()

    v_leaf = tree.v[b_k, ll]
    p_leaf = tree.prew[b_k, ll]
    term_leaf = tree.terminal[b_k, ll]
    C = torch.where(term_leaf[..., None], 0.0, v_leaf) + p_leaf  # (K,B,S)

    onf = on.to(f32)
    cnt = torch.zeros(tree.n.shape, dtype=f32, device=dev)
    cnt.index_put_((b_kl, t_path), onf, accumulate=True)
    cnt.index_put_((b_k, ll), torch.ones((K, B), dtype=f32, device=dev), accumulate=True)
    sumC = torch.zeros(tree.w.shape, dtype=f32, device=dev)
    sumC.index_put_((b_kl, t_path), C[:, :, None, :] * onf[..., None], accumulate=True)
    sumC.index_put_((b_k, ll), C, accumulate=True)

    pex = tree.prew - tree.rewards
    tree.n += torch.round(cnt * n_per_visit).to(tree.n.dtype)
    tree.w += sumC - cnt[..., None] * pex

    seat = tree.seats[b_kl, t_path].long()  # (K,B,L)
    coefw = torch.gather(C, 2, seat) - tree.prew[b_kl, t_path, seat]
    a_path = torch.gather(acts, 2, t_path).long()
    tree.n_edge.index_put_((b_kl, t_path, a_path), (onf * n_per_visit).to(tree.n_edge.dtype),
                           accumulate=True)
    tree.w_edge.index_put_((b_kl, t_path, a_path), torch.where(on, coefw, 0.0), accumulate=True)
    return tree


# --------------------------------------------------------------------------
# One pass and the search loop
# --------------------------------------------------------------------------

def simulate(tree, eval_fn, rands, cfg: MCTSConfig):
    """One K=1 simulation for every env, in place: descend, expand slot
    `sim` (or reuse the existing child where the walk halted at an expanded
    terminal child, rewriting its row as the JAX package does), step the env,
    evaluate the leaf, back up (reference mcts/__init__.py:108-140).
    rands (B,T) are the per-node uniforms.

    The descent is the `node_actions` kernel's solve and draw on every live
    row, then the `walk` kernel's chase (the JAX package's chip route). On a
    tree on the card the `backup` kernel backs up, one launch that updates
    n, w, n_edge and w_edge along the path in place, bit-equal to `backup`
    (and so refusing more than 4 seats); on the CPU the walk's recorded path
    is backed up in torch ops (`backup_path`: the CPU's fastest, where
    `backup` loops over the tree's levels)."""
    B, T, A = tree.children.shape
    with span(SOLVE):
        acts, nxt = _node_actions_any(tree, rands)
    with span(WALK):
        parents, actions, existing, path = _walk_any(tree, acts, nxt)

    with span(EXPAND):
        b = torch.arange(B, device=rands.device)
        leaves = torch.where(existing == -1, tree.sim, existing)

        pl, al, ll = parents.long(), actions.long(), leaves.long()
        tree.children[b, pl, al] = leaves.to(tree.children.dtype)
        old = _map_world(tree.worlds, lambda x: x[b, pl])
        world, transition = old.step(actions)
        with span(EVAL):
            decisions = eval_fn(world)

        def set_row(full, new):
            full[b, ll] = new.to(full.dtype)

        set_row(tree.parents, parents)
        set_row(tree.relation, actions)
        for f in fields(world):
            set_row(getattr(tree.worlds, f.name), getattr(world, f.name))
        set_row(tree.seats, world.seats)
        set_row(tree.terminal, transition.terminal)
        set_row(tree.rewards, transition.rewards)
        set_row(tree.logits, _clamp_logits(decisions["logits"]))
        set_row(tree.v, decisions["v"])
        tree.sim += 1

    n_per_visit = tree.w.shape[-1] if cfg.backup_n == "seats" else 1
    with span(BACKUP):
        if tree.n.is_cuda:
            return kernels.backup(tree, leaves, n_per_visit)
        return backup_path(tree, path, acts, leaves, n_per_visit)


def pass_shape(cfg: MCTSConfig, p):
    """(rows, max_levels) of K>1 pass p: a grow pass covers the first
    1 + (p+1)K rows, a scan pass all T. Tree depth grows at most one level a
    pass, so p+2 levels cover grow pass p and n_passes+1 every scan pass
    (the JAX `L_cap`)."""
    T = tree_size(cfg)
    if cfg.grow_passes:
        return min(T, 1 + (p + 1) * cfg.leaves_per_pass), p + 2
    return T, cfg.n_passes + 1


def _solve_and_sample(tree, rands, cfg: MCTSConfig, R):
    """The sampled action and child pointer (K,B,R) int32 of every node row,
    for each of the K rands (K,B,R), by `cfg`'s route (JAX
    `simulate_multi`'s branch order). The warm route stores its new roots
    in tree.alpha."""
    rows = (tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R])
    children = tree.children[:, :R]
    solve = dict(n_iters=cfg.solve_iters, accel=cfg.solve_accel)
    qb = _q_bounds(tree)
    if cfg.solve_kernel == "fused":
        a_bkt, c_bkt = kernels.node_actions_multi(
            *rows, children, rands.permute(1, 0, 2).contiguous(), tree.c_puct, qb, **solve)
        return a_bkt.permute(1, 0, 2), c_bkt.permute(1, 0, 2)
    if cfg.warm_solve:
        probs, alpha = node_probs(*rows, tree.c_puct, qb, warm_alpha=tree.alpha[:, :R],
                                  return_alpha=True, **solve)
        tree.alpha[:, :R] = alpha
    elif cfg.solve_kernel == "ops":
        probs = node_probs(*rows, tree.c_puct, qb, **solve)
    else:
        probs = kernels.solve_probs(*rows, tree.c_puct, qb, out=cfg.solve_kernel, **solve)
        if cfg.solve_kernel == "alpha":
            probs = node_probs(*rows, tree.c_puct, qb, fixed_alpha=probs)
    if cfg.sample_kernel:
        a_bkt, c_bkt = kernels.sample_children_multi(probs, children,
                                                     rands.permute(1, 0, 2).contiguous())
        return a_bkt.permute(1, 0, 2), c_bkt.permute(1, 0, 2)
    return _sample_children_multi(children, probs, rands, cum_mode=cfg.sample_cum)


def simulate_multi(tree, eval_fn, rands, cfg: MCTSConfig, rows, max_levels):
    """One K-leaf pass over the first `rows` node rows, in place: K walks per
    env from one all-node solve, one env step and net eval of the K*B leaf
    worlds, and one backup. rands (K,B,rows) are the per-node uniforms.

    Walks that halt at the same (parent, action) edge collapse: only the
    first writes, the others take its leaf slot (and are backed up once per
    draw). The walk records at most `max_levels` levels (`pass_shape`).

    With `backup_mode` 'prefix' a tree on the card backs up in the
    `backup_prefix` kernel, one launch that updates n, w, n_edge and w_edge
    at the pass's path nodes, edges and leaves in place, bit-equal to
    `backup_paths_prefix` on the card (and refusing more than 4 seats); a
    tree on the CPU in `backup_paths_prefix`'s torch ops."""
    K = cfg.leaves_per_pass
    B, _, A = tree.children.shape
    R = rows
    dev = tree.children.device

    with span(SOLVE):
        acts, nxts = _solve_and_sample(tree, rands, cfg, R)  # (K,B,R)

    L = min(R, max_levels)
    # the (K,B,R) views go to the kernel as they are: no copy to rows
    with span(WALK):
        p_f, a_f, h_f, path_f = kernels.walk(tree.terminal[:, :R], acts, nxts, max_levels=L)
    parents = p_f.view(K, B)
    actions = a_f.view(K, B)
    halt_child = h_f.view(K, B)
    paths = path_f.view(K, B, L)

    with span(EXPAND):
        # dedup: a walk whose edge an earlier walk of its env already took
        # redirects its leaf to that walk's slot and writes nothing of its own
        kk = torch.arange(K, device=dev)
        keys = parents * A + actions  # (K,B) edge ids
        slots = (tree.sim + kk).to(torch.int32)
        leaves0 = torch.where(halt_child == -1, slots[:, None], halt_child)
        same = (keys[:, None, :] == keys[None, :, :]) & (kk[None, :] < kk[:, None])[:, :, None]
        dup = same.any(1)  # same[k, j] for j < k
        src = torch.where(dup, torch.argmax(same.to(torch.int32), 1), kk[:, None])  # (K,B)
        leaves = torch.gather(leaves0, 0, src)

        b_k = torch.arange(B, device=dev)[None, :].expand(K, B)
        pl, al, ll = parents.long(), actions.long(), leaves.long()

        # duplicates write the same leaf, so the scatter has no conflicts
        tree.children[b_k, pl, al] = leaves.to(tree.children.dtype)

        old = _map_world(tree.worlds, lambda x: x[b_k, pl].reshape((K * B,) + x.shape[2:]))
        world_flat, transition = old.step(actions.reshape(K * B))
        with span(EVAL):
            decisions = eval_fn(world_flat)

        def set_rows(full, new_kb):
            # duplicate walks carry the first walk's values: one value per row
            full[b_k, ll] = new_kb[src, b_k].to(full.dtype)

        def unflat(x):
            return x.reshape((K, B) + x.shape[1:])

        if tree.prew is not None:
            set_rows(tree.prew, tree.prew[b_k, pl] + unflat(transition.rewards))
        set_rows(tree.parents, parents)
        set_rows(tree.relation, actions)
        for f in fields(world_flat):
            set_rows(getattr(tree.worlds, f.name), unflat(getattr(world_flat, f.name)))
        set_rows(tree.seats, unflat(world_flat.seats))
        set_rows(tree.terminal, unflat(transition.terminal))
        set_rows(tree.rewards, unflat(transition.rewards))
        set_rows(tree.logits, unflat(_clamp_logits(decisions["logits"])))
        set_rows(tree.v, unflat(decisions["v"]))
        tree.sim += K

    n_per_visit = tree.w.shape[-1] if cfg.backup_n == "seats" else 1
    if cfg.backup_mode == "einsum":
        backup = backup_paths
    elif tree.n.is_cuda:
        backup = kernels.backup_prefix
    else:
        backup = backup_paths_prefix
    with span(BACKUP):
        return backup(tree, paths, acts, leaves, n_per_visit)


def mcts(world, eval_fn, draws: Draws, cfg: MCTSConfig):
    """Full search: seed the root, then n_nodes-1 sequential sims (K=1), or
    ceil((n_nodes-1)/K) K-leaf passes, each over the rows `pass_shape`
    gives (grow or scan passes)."""
    with span(ROOT):
        tree = build(world, cfg)
        tree = initialize(tree, eval_fn(world), draws, cfg, world.valid)
    K = cfg.leaves_per_pass
    B, T = tree.parents.shape
    if K == 1:
        for i in range(cfg.n_nodes - 1):
            with span(SIM, index=i):
                simulate(tree, eval_fn, draws.sim_rands(i, (B, T)), cfg)
        return tree
    for p in range(cfg.n_passes):
        R, L = pass_shape(cfg, p)
        with span(PASS, index=p):
            simulate_multi(tree, eval_fn, draws.pass_rands(p, (K, B, R)), cfg, rows=R,
                           max_levels=L)
    return tree


def root(tree):
    """The improved root policy (training target), prior and root value."""
    probs = _node_policy(tree, 0, _q_bounds(tree))
    return {
        "logits": torch.log(probs),
        "prior": _unclamp_logits(tree.logits[:, 0].float()),
        "v": tree.v[:, 0],
    }


def n_leaves(tree):
    """Number of leaf nodes per env."""
    return ((tree.children == -1).all(-1) & (tree.parents != -1)).sum(-1)


class _Agent:
    """Runs on the world's device; `draws` defaults to the agent's own
    `Draws`, seeded once on that device, so successive calls draw fresh
    numbers."""

    def __init__(self, eval_fn, seed=0):
        self.eval_fn = eval_fn
        self.seed = seed
        self.draws = None

    def _draws(self, world, draws):
        if draws is not None:
            return draws
        if self.draws is None or self.draws.device != world.device:
            self.draws = Draws(self.seed, world.device)
        return self.draws


def _act(logits, draws, eval):
    """The argmax action, or a draw from the policy: argmax(logits + Gumbel
    noise), which is how `jax.random.categorical` draws."""
    if eval:
        return torch.argmax(logits, -1).to(torch.int32)
    return torch.argmax(logits + draws.gumbel(logits.shape), -1).to(torch.int32)


class MCTSAgent(_Agent):
    """Agent over MCTS: `agent(world, draws, eval=False)` returns the improved
    policy, the sampled (or argmax) action and telemetry."""

    def __init__(self, eval_fn, seed=0, **kwargs):
        super().__init__(eval_fn, seed)
        self.cfg = MCTSConfig(**kwargs)

    def __call__(self, world, draws=None, eval=False, **overrides):
        cfg = replace(self.cfg, **overrides) if overrides else self.cfg
        draws = self._draws(world, draws)
        tree = mcts(world, self.eval_fn, draws, cfg)
        r = root(tree)
        B = world.n_envs
        return {
            "logits": r["logits"],
            "prior": r["prior"],
            "v": r["v"],
            "actions": _act(r["logits"], draws, eval),
            "n_sims": torch.full((B,), cfg.n_nodes, dtype=torch.int32, device=world.device),
            "n_leaves": n_leaves(tree),
        }


class DummyAgent(_Agent):
    """No-search baseline: act from the network alone, with `MCTSAgent`'s
    output keys."""

    def __call__(self, world, draws=None, eval=False):
        r = self.eval_fn(world)
        B = world.n_envs
        return {
            "logits": r["logits"],
            "prior": r["logits"],
            "v": r["v"],
            "actions": _act(r["logits"], self._draws(world, draws), eval),
            "n_sims": torch.zeros((B,), dtype=torch.int32, device=world.device),
            "n_leaves": torch.ones((B,), dtype=torch.int32, device=world.device),
        }
