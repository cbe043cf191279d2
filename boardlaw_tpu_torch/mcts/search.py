"""Batched regularized-policy MCTS with the tree held as dense (B, T, ...)
tensors. Counterpart of boardlaw_tpu/mcts/search.py, for its production
multi-leaf path: K leaves per pass, grow passes and the prefix backup.

Each pass runs, over the first R = 1 + (p+1)K node rows of pass p:

* the all-node solve of pi_bar(a) = lambda_N pi(a) / (alpha - q(a)) and K
  inverse-CDF draws per node, in the `node_actions_multi` kernel;
* the K*B root->leaf pointer chases, in the `walk` kernel;
* dedup of walks that halt at one edge, the Hex step and the network eval of
  the K*B leaf worlds, and the row writes, as index gathers and scatters;
* the prefix backup (`backup_paths_prefix`).

The JAX package routes its row reads and writes through one-hot einsums and
grows the tree by slicing and padding (`_slice_tree`, `_pad_tree`); both are
TPU formulations. Here the tree is allocated at its full T once and each
pass hands the kernels the leading R rows as strided views; rows beyond R
are still at their `build()` values, exactly what the JAX package pads in.
The values are the same; the dataflow is not.

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


@dataclass(frozen=True)
class MCTSConfig:
    """Search configuration of the port.

    The knobs that describe only TPU dataflow are not carried: the
    `pallas_*` switches and block sizes, `use_pallas`, `write_mode`,
    `gather_mode`, `mesh`/`mesh_axis`, `tree_dtype` and `compact`. The port
    always runs its two kernels on the card, stores logits in float32 and
    keeps the compact tree (int8 children, bf16 edge counts), and samples
    with the log-shift prefix sum (the JAX `sample_cum='shift'` order).

    Configurations this slice does not carry raise a ValueError naming the
    slice that brings them.
    """

    n_nodes: int = 64
    c_puct: float = 1 / 16
    noise_eps: float = 0.25
    alpha_scale: float = 10.0
    backup_n: str = "seats"  # 'seats' = reference behaviour, 'visits' = fixed
    leaves_per_pass: int = 8
    solve_iters: int = 6
    solve_accel: bool = True
    warm_solve: bool = False
    grow_passes: bool = True
    backup_mode: str = "prefix"

    def __post_init__(self):
        if self.leaves_per_pass < 2:
            raise ValueError(
                "leaves_per_pass=1 (the sequential K=1 search) comes with the next "
                "slice, which ports the node_actions kernel")
        if not self.grow_passes:
            raise ValueError("scan-mode passes (grow_passes=False) come in a later slice")
        if self.backup_mode != "prefix":
            raise ValueError(f"backup_mode={self.backup_mode!r} (the einsum backup) comes "
                             "in a later slice; this slice carries 'prefix'")
        if self.warm_solve:
            raise ValueError("warm_solve comes in a later slice")
        if self.backup_n not in ("seats", "visits"):
            raise ValueError(f"backup_n must be 'seats' or 'visits', got {self.backup_n!r}")
        if tree_size(self) > 127:
            raise ValueError(
                f"n_nodes={self.n_nodes} needs {tree_size(self)} node slots; the compact "
                "tree (int8 children) of this slice holds at most 127")

    @property
    def n_passes(self):
        return -(-(self.n_nodes - 1) // self.leaves_per_pass)


def tree_size(cfg):
    """Node slots: K per pass plus the root."""
    return 1 + cfg.leaves_per_pass * (-(-(cfg.n_nodes - 1) // cfg.leaves_per_pass))


@dataclass
class Tree:
    """The search tree of every env. Edge statistics mirror child node
    statistics: n_edge[b,p,a] == n[b,c] and w_edge[b,p,a] == w[b,c,seat(p)]
    for the edge (p, a) -> c."""

    children: torch.Tensor  # (B,T,A) int8, -1 = unexpanded
    parents: torch.Tensor  # (B,T) int32, -1 = no parent
    relation: torch.Tensor  # (B,T) int32, action that led here
    worlds: object  # world dataclass with fields (B,T,...)
    seats: torch.Tensor  # (B,T) int32 seat to play per node
    terminal: torch.Tensor  # (B,T) bool
    rewards: torch.Tensor  # (B,T,S) f32
    logits: torch.Tensor  # (B,T,A) f32 log-prior per node (clamped)
    v: torch.Tensor  # (B,T,S) f32 network value per node
    n: torch.Tensor  # (B,T) int32 visit counts
    w: torch.Tensor  # (B,T,S) f32 value sums
    n_edge: torch.Tensor  # (B,T,A) bf16 visits of each child (exact up to 256)
    w_edge: torch.Tensor  # (B,T,A) f32 child value sums for the parent's seat
    c_puct: torch.Tensor  # (B,) f32
    sim: int  # next free node slot
    prew: torch.Tensor  # (B,T,S) f32 cumulative rewards root->node inclusive


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

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return Tree(
        children=full((B, T, A), -1, torch.int8),
        parents=full((B, T), -1, torch.int32),
        relation=full((B, T), -1, torch.int32),
        worlds=_map_world(world, lambda x: x[:, None].expand((B, T) + x.shape[1:]).clone()),
        seats=world.seats.to(torch.int32)[:, None].expand(B, T).clone(),
        terminal=zeros(B, T, dtype=torch.bool),
        rewards=zeros(B, T, S),
        logits=zeros(B, T, A),
        v=zeros(B, T, S),
        n=zeros(B, T, dtype=torch.int32),
        w=zeros(B, T, S),
        n_edge=zeros(B, T, A, dtype=torch.bfloat16),
        w_edge=zeros(B, T, A),
        c_puct=full((B,), cfg.c_puct, f32),
        sim=0,
        prew=zeros(B, T, S),
    )


# Finite stand-in for -inf inside tree tensors: exp(-1e4) underflows to 0.
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
# node_actions_multi kernel computes both in one pass)
# --------------------------------------------------------------------------

def solve_policy(pi, q, lambda_n, tol=1e-3, n_iters=16, return_alpha=False, accel=False):
    """Solve pi_bar(a) = lambda_n*pi(a)/(alpha - q(a)) for alpha with
    sum_a pi_bar = 1, over rows. pi, q (R,A); lambda_n (R,).

    A fixed number of steps with frozen rows once converged. Newton with the
    one-sided err < tol test, or with `accel` safeguarded-Halley steps (the
    Newton step times 1/(1-t), t = err*s''/(2 s'^2), only from below the
    root and while t < 0.75, the factor capped at 4) with the two-sided
    |err| < tol test."""
    lam = lambda_n[:, None].float()
    pi = pi.float()
    q = q.float()

    lampi = lam * pi
    gap = torch.clamp_min(lampi, 1e-4)
    alpha = (q + gap).max(-1).values
    floor = q.max(-1).values + 1e-6
    done = torch.zeros(alpha.shape, dtype=torch.bool, device=alpha.device)

    for _ in range(n_iters):
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


def _node_policy(tree, t, q_bounds):
    """pi_bar of node row t of every env (the 16-step Newton solve)."""
    q, counts = _edge_q_counts(tree.n_edge[:, t], tree.w_edge[:, t], q_bounds)
    pi = torch.exp(tree.logits[:, t].float())
    A = pi.shape[-1]
    N = counts.sum(-1)
    lambda_n = tree.c_puct * N / (N + A)
    return solve_policy(pi, q, lambda_n)


def _q_bounds(tree):
    """Global (min, max) of the per-(node, seat) q estimates w/n over all
    envs, as a (2,) tensor on the tree's device. Rows beyond a pass's R hold
    zeros, as do its unwritten rows, so the full tree gives the bounds of
    the first R rows."""
    q = tree.w / (tree.n[..., None].float() + 1e-4)
    return torch.stack([q.min(), q.max()])


def node_probs(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=16, accel=False,
               return_alpha=False):
    """Solved pi_bar for every node row: (B,T,A) tensors -> (B,T,A) f32
    (and the (B,T) alphas with `return_alpha`)."""
    B, T, A = logits.shape
    q, counts = _edge_q_counts(n_edge, w_edge, q_bounds)
    pi = torch.exp(logits.float())
    N = counts.sum(-1)
    lam = c_puct[:, None] * N / (N + A)
    probs, alpha = solve_policy(pi.reshape(B * T, A), q.reshape(B * T, A), lam.reshape(B * T),
                                n_iters=n_iters, accel=accel, return_alpha=True)
    probs = probs.reshape(B, T, A)
    return (probs, alpha.reshape(B, T)) if return_alpha else probs


def _sample_children_multi(children, probs, rands):
    """K draws per node from solved probs (B,T,A) with rands (K,B,T) ->
    (actions, child) (K,B,T) int32: the first lane with prob > 0 and
    cum >= r, else the last positive lane (child 0 when a row has none),
    with the inclusive prefix sum taken in the log-shift (Hillis-Steele)
    order of the JAX package's `cum_mode='shift'`."""
    K = rands.shape[0]
    A = probs.shape[-1]
    lane = torch.arange(A, device=probs.device)
    pos = probs > 0
    last_pos = torch.where(pos, lane, -1).max(-1).values

    cum = probs
    shift = 1
    while shift < A:
        cum = cum + F.pad(cum, (shift, 0))[..., :A]
        shift *= 2

    big = A + 1
    acts, childs = [], []
    for k in range(K):
        ok = pos & (cum >= rands[k][..., None])
        first = torch.where(ok, lane, big).min(-1).values
        a_k = torch.where(first < big, first, last_pos)
        c_k = torch.gather(children, -1, a_k.clamp_min(0)[..., None].long())[..., 0]
        acts.append(a_k.to(torch.int32))
        childs.append(torch.where(a_k >= 0, c_k.to(torch.int32), 0))
    return torch.stack(acts), torch.stack(childs)


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


# --------------------------------------------------------------------------
# Backup
# --------------------------------------------------------------------------

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
    and w/w_edge to float32 roundoff."""
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

def simulate_multi(tree, eval_fn, rands, cfg: MCTSConfig, rows, max_levels):
    """One K-leaf pass over the first `rows` node rows, in place: K walks per
    env from one all-node solve, one env step and net eval of the K*B leaf
    worlds, and one backup. rands (K,B,rows) are the per-node uniforms.

    Walks that halt at the same (parent, action) edge collapse: only the
    first writes, the others take its leaf slot (and are backed up once per
    draw). The walk records at most `max_levels` levels; the tree grows at
    most one level per pass, so p+2 covers pass p."""
    K = cfg.leaves_per_pass
    B, _, A = tree.children.shape
    R = rows
    dev = tree.children.device

    a_bkt, c_bkt = kernels.node_actions_multi(
        tree.logits[:, :R], tree.n_edge[:, :R], tree.w_edge[:, :R], tree.children[:, :R],
        rands.permute(1, 0, 2).contiguous(), tree.c_puct, _q_bounds(tree),
        n_iters=cfg.solve_iters, accel=cfg.solve_accel)
    acts = a_bkt.permute(1, 0, 2)  # (K,B,R)
    nxts = c_bkt.permute(1, 0, 2)

    L = min(R, max_levels)
    p_f, a_f, h_f, path_f = kernels.walk(
        tree.terminal[:, :R], acts.reshape(K * B, R), nxts.reshape(K * B, R), max_levels=L)
    parents = p_f.view(K, B)
    actions = a_f.view(K, B)
    halt_child = h_f.view(K, B)
    paths = path_f.view(K, B, L)

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
    decisions = eval_fn(world_flat)

    def set_rows(full, new_kb):
        # duplicate walks carry the first walk's values: one value per row
        full[b_k, ll] = new_kb[src, b_k].to(full.dtype)

    def unflat(x):
        return x.reshape((K, B) + x.shape[1:])

    p_par = tree.prew[b_k, pl]
    set_rows(tree.prew, p_par + unflat(transition.rewards))
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
    return backup_paths_prefix(tree, paths, acts, leaves, n_per_visit)


def mcts(world, eval_fn, draws: Draws, cfg: MCTSConfig):
    """Full search: seed the root, then ceil((n_nodes-1)/K) grow passes, pass
    p over the first 1 + (p+1)K node rows."""
    tree = build(world, cfg)
    tree = initialize(tree, eval_fn(world), draws, cfg, world.valid)
    K = cfg.leaves_per_pass
    B, T = tree.parents.shape
    for p in range(cfg.n_passes):
        R = min(T, 1 + (p + 1) * K)
        rands = draws.pass_rands(p, (K, B, R))
        simulate_multi(tree, eval_fn, rands, cfg, rows=R, max_levels=p + 2)
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


class MCTSAgent:
    """Agent over MCTS: `agent(world, draws, eval=False)` returns the improved
    policy, the sampled (or argmax) action and telemetry. Runs on the
    world's device; `draws` defaults to the agent's own `Draws`, seeded once
    on that device, so successive calls draw fresh numbers."""

    def __init__(self, eval_fn, seed=0, **kwargs):
        self.eval_fn = eval_fn
        self.seed = seed
        self.draws = None
        self.cfg = MCTSConfig(**kwargs)

    def __call__(self, world, draws=None, eval=False, **overrides):
        cfg = replace(self.cfg, **overrides) if overrides else self.cfg
        if draws is None:
            if self.draws is None or self.draws.device != world.device:
                self.draws = Draws(self.seed, world.device)
            draws = self.draws
        tree = mcts(world, self.eval_fn, draws, cfg)
        r = root(tree)
        if eval:
            actions = torch.argmax(r["logits"], -1)
        else:
            actions = torch.argmax(r["logits"] + draws.gumbel(r["logits"].shape), -1)
        B = world.n_envs
        return {
            "logits": r["logits"],
            "prior": r["prior"],
            "v": r["v"],
            "actions": actions.to(torch.int32),
            "n_sims": torch.full((B,), cfg.n_nodes, dtype=torch.int32, device=world.device),
            "n_leaves": n_leaves(tree),
        }
