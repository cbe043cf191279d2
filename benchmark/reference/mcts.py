"""The plain regularized-policy search, for the two routes the cells run:
K = 1 (one leaf a simulation, `n_nodes - 1` simulations) and K > 1 with
grow passes (K leaves a pass, pass p over the first 1 + (p+1)K node rows).

Each node row solves pi_bar(a) = lambda_N pi(a) / (alpha - q(a)) for alpha
with sum pi_bar = 1 (Newton steps, or safeguarded Halley steps for K > 1),
draws its action(s) by inverse CDF over the log-shift prefix sum with
uniforms drawn for every node, and the walks follow the drawn children from
the root to an unexpanded or terminal child. The new leaves are stepped,
evaluated and backed up along their recorded paths, the visit counts
counted once per seat. The root carries Dirichlet noise (fixed-round
Marsaglia-Tsang gammas). The result is the root's solved policy.

The tree is a dict of dense (B,T,...) tensors; counts are held in float32
and int64, which hold the same integers as any narrower storage. The
logits are stored in the configuration's `tree_dtype` ("float32" or
"bfloat16"): every write rounds into it, the -inf proxy included (-9984 in
bf16), and every solve reads them widened to float32. The prior is the
stored root row, so in bf16 it keeps -9984 at invalid actions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import hex

NEG_INF_PROXY = -1e4


def tree_size(n_nodes, K):
    return 1 + K * (-(-(n_nodes - 1) // K))


def pass_shape(n_nodes, K, p):
    """(rows, levels) of grow pass p."""
    return min(tree_size(n_nodes, K), 1 + (p + 1) * K), p + 2


def _log_gamma(a, normals, uniforms, boost_uniforms):
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


def _noised(logits, valid, draws, eps=0.25, alpha_scale=10.0, rounds=4):
    A = logits.shape[-1]
    normals, uniforms, boost = draws.dirichlet(logits.shape, rounds)
    log_g = _log_gamma(alpha_scale / A, normals, uniforms, boost)
    log_g = torch.where(valid, log_g, -torch.inf)
    draw = torch.exp(log_g - log_g.max(-1, keepdim=True).values)
    draw = draw / draw.sum(-1, keepdim=True)
    return torch.log(torch.exp(logits.float()) * (1 - eps) + draw * eps)


def _solve(logits, n_edge, w_edge, c_puct, bounds, n_iters, accel, tol=1e-3):
    """Solved pi_bar of (B,R,A) rows -> (B,R,A) f32."""
    B, R, A = logits.shape
    lo, hi = bounds[0], bounds[1]
    expanded = n_edge > 0
    q = torch.where(expanded, (w_edge / (n_edge + 1e-4) - lo) / (hi - lo + 1e-4), 0.0)
    N = torch.where(expanded, n_edge, 1.0).sum(-1)
    lam = (c_puct[:, None] * N / (N + A)).reshape(B * R)[:, None]
    pi = torch.exp(logits.float()).reshape(B * R, A)
    q = q.reshape(B * R, A)
    lampi = lam * pi
    alpha = (q + torch.clamp_min(lampi, 1e-4)).max(-1).values
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
    return (lampi / (alpha[:, None] - q)).reshape(B, R, A)


def _draws(probs, children, rands):
    """K inverse-CDF draws per row over the log-shift prefix sum: the first
    positive lane with cum >= u, else the last positive lane. probs (B,R,A),
    rands (K,B,R) -> actions, children (K,B,R) int64 (-1 / 0 where a row
    has no positive lane)."""
    A = probs.shape[-1]
    cum, shift = probs, 1
    while shift < A:
        cum = cum + F.pad(cum, (shift, 0))[..., :A]
        shift *= 2
    lane = torch.arange(A, device=probs.device)
    pos = probs > 0
    last = torch.where(pos, lane, -1).max(-1).values
    acts, kids = [], []
    for u in rands:
        first = torch.where(pos & (cum >= u[..., None]), lane, A + 1).min(-1).values
        a = torch.where(first < A + 1, first, last)
        c = torch.gather(children, -1, a.clamp_min(0)[..., None])[..., 0]
        acts.append(a)
        kids.append(torch.where(a >= 0, c, 0))
    return torch.stack(acts), torch.stack(kids)


def _walk(acts, kids, terminal, levels):
    """Root-to-leaf chases over (N,R) rows of drawn actions and children,
    terminal (N,R). -> parents, actions, halt child (N,) and the path (N,L)
    of nodes visited before the halt (-1 past it)."""
    N, R = acts.shape
    dev = acts.device
    halt = (kids == -1) | torch.gather(terminal, 1, kids.clamp_min(0))
    t = torch.zeros(N, dtype=torch.int64, device=dev)
    active = ~terminal[:, 0]
    parents = torch.zeros(N, dtype=torch.int64, device=dev)
    actions = torch.full((N,), -1, dtype=torch.int64, device=dev)
    halt_child = torch.full((N,), -1, dtype=torch.int64, device=dev)
    path = []
    for _ in range(min(R, levels)):
        a, c, h = (torch.gather(x, 1, t[:, None])[:, 0] for x in (acts, kids, halt))
        parents = torch.where(active, t, parents)
        actions = torch.where(active, a, actions)
        path.append(torch.where(active, t, -1))
        halt_child = torch.where(active & h, c, halt_child)
        active = active & ~h
        t = torch.where(active, c, t)
    return parents, actions, halt_child, torch.stack(path, 1)


def _bounds(tree):
    q = tree["w"] / (tree["n"][..., None].float() + 1e-4)
    return torch.stack([q.min(), q.max()])


def _expand(tree, b, parents, actions, leaves, first, evaluate):
    """Step the parents' worlds by the actions, evaluate, and write the
    leaves' rows. b, parents, actions, leaves (M,) index the envs; `first`
    (M,) picks, for each, the entry whose values its leaf row takes."""
    tree["children"][b, parents, actions] = leaves
    board, seats, terminal, rewards = hex.step(tree["board"][b, parents], tree["seats"][b, parents],
                                               actions)
    logits, v = evaluate(board, seats)
    rows = {"parents": parents, "relation": actions, "board": board, "seats": seats,
            "terminal": terminal, "rewards": rewards,
            "logits": torch.clamp_min(logits, NEG_INF_PROXY), "v": v}
    if "prew" in tree:
        rows["prew"] = tree["prew"][b, parents] + rewards
    for k, x in rows.items():
        tree[k][b, leaves] = x[first].to(tree[k].dtype)


def _backup(tree, paths, acts, leaves):
    """Back up K recorded paths per env: paths (K,B,L), acts (K,B,R),
    leaves (K,B). The value backed up at a path node is the leaf's value
    (0 if terminal) plus the rewards from the node down to the leaf, taken
    from the cumulative rewards `prew`; each visit counts once per seat."""
    K, B, L = paths.shape
    dev = paths.device
    seats = tree["w"].shape[-1]
    bk = torch.arange(B, device=dev)[None].expand(K, B)
    bkl = bk[..., None].expand(K, B, L)
    on = (paths >= 0).float()
    t = paths.clamp_min(0)
    C = torch.where(tree["terminal"][bk, leaves][..., None], 0.0, tree["v"][bk, leaves]) \
        + tree["prew"][bk, leaves]
    cnt = torch.zeros(tree["n"].shape, device=dev)
    cnt.index_put_((bkl, t), on, accumulate=True)
    cnt.index_put_((bk, leaves), torch.ones((K, B), device=dev), accumulate=True)
    sumC = torch.zeros(tree["w"].shape, device=dev)
    sumC.index_put_((bkl, t), C[:, :, None, :] * on[..., None], accumulate=True)
    sumC.index_put_((bk, leaves), C, accumulate=True)
    tree["n"] += torch.round(cnt * seats).long()
    tree["w"] += sumC - cnt[..., None] * (tree["prew"] - tree["rewards"])
    seat = tree["seats"][bkl, t].long()
    coef = torch.gather(C, 2, seat) - tree["prew"][bkl, t, seat]
    a = torch.gather(acts, 2, t)
    tree["n_edge"].index_put_((bkl, t, a), on * seats, accumulate=True)
    tree["w_edge"].index_put_((bkl, t, a), torch.where(paths >= 0, coef, 0.0), accumulate=True)


def _backup_path(tree, path, acts, leaves):
    """Back up one recorded path per env: path (B,L) the nodes above the
    leaf, acts (B,R), leaves (B,)."""
    B, L = path.shape
    dev = path.device
    seats = tree["w"].shape[-1]
    b = torch.arange(B, device=dev)
    depth = (path >= 0).sum(1)
    nodes = torch.cat([path, torch.full((B, 1), -1, dtype=path.dtype, device=dev)], 1)
    nodes[b, depth] = leaves
    on = nodes >= 0
    safe = nodes.clamp_min(0)
    base = torch.where(tree["terminal"][b, leaves][:, None], 0.0, tree["v"][b, leaves])
    x = torch.where(on[..., None], tree["rewards"][b[:, None], safe], 0.0)
    x[b, depth] += base
    dw = torch.where(on[..., None], x.flip(1).cumsum(1).flip(1), 0.0)
    dn = on.float() * seats
    parent = safe[:, :L]
    edge_on = on[:, 1:]
    edge_a = torch.where(edge_on, torch.gather(acts, 1, parent.clamp_max(acts.shape[1] - 1)), 0)
    seat = tree["seats"][b[:, None], parent].long().clamp(0, seats - 1)
    edge_w = torch.where(edge_on, torch.gather(dw[:, 1:], 2, seat[..., None])[..., 0], 0.0)
    bb = b[:, None]
    tree["n"].index_put_((bb.expand(B, L + 1), safe), torch.round(dn).long(), accumulate=True)
    tree["w"].index_put_((bb.expand(B, L + 1), safe), dw, accumulate=True)
    idx = (bb.expand(B, L), safe[:, :L], edge_a)
    tree["n_edge"].index_put_(idx, dn[:, 1:], accumulate=True)
    tree["w_edge"].index_put_(idx, edge_w, accumulate=True)


def search(board, seats, evaluate, draws, n_nodes, K, c_puct, noise_eps=0.25,
           tree_dtype="float32"):
    """The search from every env's root. evaluate(board, seats) -> (logits,
    v); `tree_dtype` names the logits' storage type. -> (root log-policy
    (B,A), prior (B,A), root value (B,2), n_leaves (B,))."""
    B, S, _ = board.shape
    A, T = S * S, tree_size(n_nodes, K)
    dev = board.device
    f32 = torch.float32
    tree = {
        "children": torch.full((B, T, A), -1, dtype=torch.int64, device=dev),
        "parents": torch.full((B, T), -1, dtype=torch.int64, device=dev),
        "relation": torch.full((B, T), -1, dtype=torch.int64, device=dev),
        "board": board[:, None].expand(B, T, S, S).clone(),
        "seats": seats[:, None].expand(B, T).clone(),
        "terminal": torch.zeros((B, T), dtype=torch.bool, device=dev),
        "rewards": torch.zeros((B, T, 2), dtype=f32, device=dev),
        "logits": torch.zeros((B, T, A), dtype=getattr(torch, tree_dtype), device=dev),
        "v": torch.zeros((B, T, 2), dtype=f32, device=dev),
        "n": torch.zeros((B, T), dtype=torch.int64, device=dev),
        "w": torch.zeros((B, T, 2), dtype=f32, device=dev),
        "n_edge": torch.zeros((B, T, A), dtype=f32, device=dev),
        "w_edge": torch.zeros((B, T, A), dtype=f32, device=dev),
    }
    if K > 1:
        tree["prew"] = torch.zeros((B, T, 2), dtype=f32, device=dev)
    c = torch.full((B,), c_puct, dtype=f32, device=dev)
    logits, v = evaluate(board, seats)
    noised = _noised(logits, hex.valid(board, seats), draws, noise_eps)
    tree["logits"][:, 0] = torch.clamp_min(noised, NEG_INF_PROXY)
    tree["v"][:, 0] = v
    b = torch.arange(B, device=dev)
    sim = 1

    def rows(R, solve):
        return (tree["logits"][:, :R], tree["n_edge"][:, :R], tree["w_edge"][:, :R], c,
                _bounds(tree), *solve)

    if K == 1:
        for i in range(n_nodes - 1):
            u = draws.sim_rands(i, (B, T))
            R = sim
            probs = _solve(*rows(R, (16, False)))
            acts, kids = _draws(probs, tree["children"][:, :R], u[None, :, :R])
            parents, actions, halt, path = _walk(acts[0], kids[0], tree["terminal"][:, :R], R)
            leaves = torch.where(halt == -1, sim, halt)
            _expand(tree, b, parents, actions, leaves, b, evaluate)
            sim += 1
            _backup_path(tree, path, acts[0], leaves)
    else:
        kk = torch.arange(K, device=dev)
        for p in range(-(-(n_nodes - 1) // K)):
            R, L = pass_shape(n_nodes, K, p)
            u = draws.pass_rands(p, (K, B, R))
            probs = _solve(*rows(R, (6, True)))
            acts, kids = _draws(probs, tree["children"][:, :R], u)
            term = tree["terminal"][:, :R].repeat(K, 1)
            parents, actions, halt, paths = _walk(acts.reshape(K * B, R), kids.reshape(K * B, R),
                                                  term, L)
            parents, actions, halt = (x.view(K, B) for x in (parents, actions, halt))
            # walks of one env that end on one edge share the first one's leaf
            key = parents * A + actions
            same = (key[:, None] == key[None]) & (kk[None, :] < kk[:, None])[..., None]
            first = torch.where(same.any(1), torch.argmax(same.int(), 1), kk[:, None])
            leaves = torch.gather(torch.where(halt == -1, (sim + kk)[:, None], halt), 0, first)
            bk = b[None].expand(K, B)
            flat = (first * B + bk).reshape(-1)
            _expand(tree, bk.reshape(-1), parents.reshape(-1), actions.reshape(-1),
                    leaves.reshape(-1), flat, evaluate)
            sim += K
            _backup(tree, paths.view(K, B, -1), acts, leaves)
    probs = _solve(tree["logits"][:, :1], tree["n_edge"][:, :1], tree["w_edge"][:, :1], c,
                   _bounds(tree), 16, False)[:, 0]
    prior = tree["logits"][:, 0].float()
    n_leaves = ((tree["children"] == -1).all(-1) & (tree["parents"] != -1)).sum(-1)
    return (torch.log(probs), torch.where(prior <= NEG_INF_PROXY, -torch.inf, prior),
            tree["v"][:, 0], n_leaves)
