"""The plain self-play train step: one search per env, a draw from the
improved root policy, one Hex step, the record pushed into a circular
buffer of the last T steps, value targets by reward-to-go over the
time-ordered buffer, one timestep per env drawn for the batch, the policy
cross-entropy against the stored root policy plus the value MSE, and one
Adam step (lr, betas 0.9/0.999, eps 1e-8).

State is a dict: board, seats (the worlds), buffer (dict of (T,B,...)
tensors), ptr (next slot), params (dict of the network's leaves, its
buffers too), m, v (Adam moments of the trainable leaves), t (Adam steps).
The network is the configuration's (`nets.module`): the searches run its
forward, the loss its train-mode forward, which moves its buffers; Adam
steps the trainable leaves alone.

`fault` plants one fault for the control readings: "answer" rolls the
root policy by one action where the actor produces it (and the mix's
draws, where the benchmark replays them), "half" takes the loss over the
first half of the batch.
"""
from __future__ import annotations

import torch

from . import hex, mcts, nets

BETAS, EPS = (0.9, 0.999), 1e-8


def evaluator(params, cfg, prec):
    net = nets.module(cfg)

    def evaluate(board, seats):
        return net.forward(params, hex.observe(board, seats), hex.valid(board, seats), seats, cfg,
                           prec)
    return evaluate


@torch.no_grad()
def actor(cfg, params, board, seats, draws, prec="float32", fault=None):
    """-> (next board, next seats, record, actions)."""
    logits, prior, v, n_leaves = mcts.search(board, seats, evaluator(params, cfg, prec),
                                             draws, cfg["n_nodes"], cfg["leaves_per_pass"],
                                             cfg["c_puct"], cfg["noise_eps"],
                                             cfg.get("tree_dtype", "float32"))
    if fault == "answer":
        logits = logits.roll(1, -1)
    actions = torch.argmax(logits + draws.gumbel(logits.shape), -1)
    nb, ns, terminal, rewards = hex.step(board, seats, actions)
    record = {"board": board, "seats": seats, "logits": logits.to(torch.bfloat16),
              "prior": prior.to(torch.bfloat16), "v": v, "n_leaves": n_leaves.int(),
              "terminal": terminal, "rewards": rewards}
    return nb, ns, record, actions


def reward_to_go(reward, value, terminal):
    """Reverse recursion over time: the last step's value (its reward if
    terminal), then reward + next target, cut at terminals."""
    fallback = torch.where(terminal, reward, value)
    out = [fallback[-1]]
    for t in range(fallback.shape[0] - 2, -1, -1):
        out.append(torch.where(terminal[t], fallback[t], reward[t] + out[-1]))
    return torch.stack(out[::-1])


def losses(cfg, params, batch, prec):
    obs = hex.observe(batch["board"], batch["seats"])
    logits, v = nets.module(cfg).forward(params, obs, hex.valid(batch["board"], batch["seats"]),
                                         batch["seats"], cfg, prec, train=True)
    zeros = torch.zeros_like(logits)
    l = torch.where(logits > -torch.inf, logits, zeros)
    targets = batch["logits"].float()
    l0 = torch.where(targets > -torch.inf, targets, zeros)
    policy = -(torch.exp(l0) * l).sum(-1).mean()
    value = torch.square(batch["reward_to_go"] - v).mean()
    return policy, value


def train_step(cfg, st, draws, prec="float32", fault=None):
    """One step, in place on `st`. -> dict of the step's outputs: next
    board/seats, the record, the loss terms (total, policy, value) and the
    gradient of the trainable leaves."""
    buf, T = st["buffer"], cfg["buffer_len"]
    nb, ns, record, _ = actor(cfg, st["params"], st["board"], st["seats"], draws, prec, fault)
    for k, x in record.items():
        buf[k][st["ptr"]] = x
    ptr = (st["ptr"] + 1) % T
    order = (ptr + torch.arange(T, device=nb.device)) % T
    rewards, value, terminal = buf["rewards"][order], buf["v"][order], buf["terminal"][order]
    rtg = reward_to_go(rewards, value, terminal[..., None].expand(rewards.shape))

    B = nb.shape[0]
    t_idx = draws.slots(B, T).long()
    envs = torch.arange(B, device=nb.device)
    slot = (ptr + t_idx) % T
    batch = {k: x[slot, envs] for k, x in buf.items()}
    batch["reward_to_go"] = rtg[t_idx, envs]
    if fault == "half":
        batch = {k: x[:B // 2] for k, x in batch.items()}

    trained = nets.trainable(nets.module(cfg).layout(cfg))
    params = {k: st["params"][k].detach().requires_grad_(True) for k in trained}
    leaves = dict(st["params"], **params)
    with nets.precision(prec):
        policy, value = losses(cfg, leaves, batch, prec)
        total = policy + value
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    # the buffers as the train-mode forward left them
    st["params"].update((k, x) for k, x in leaves.items() if k not in params)

    st["t"] += 1
    t = st["t"]
    b1, b2 = BETAS
    with torch.no_grad():
        for k, g in grads.items():
            st["m"][k] = b1 * st["m"][k] + (1 - b1) * g
            st["v"][k] = b2 * st["v"][k] + (1 - b2) * g * g
            mhat = st["m"][k] / (1 - b1 ** t)
            vhat = st["v"][k] / (1 - b2 ** t)
            st["params"][k] = st["params"][k] - cfg["lr"] * mhat / (torch.sqrt(vhat) + EPS)
    st["board"], st["seats"], st["ptr"] = nb, ns, ptr
    return {"board": nb, "seats": ns, "record": record,
            "loss": [float(total.detach()), float(policy.detach()), float(value.detach())],
            "grad": grads}
