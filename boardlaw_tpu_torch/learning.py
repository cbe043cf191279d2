"""Training utilities: env warmup, returns, entropy and the gradient noise
scale. Counterpart of boardlaw_tpu/learning.py."""
from __future__ import annotations

import torch

from .utils.profiling import span

MIX = "train.mix"  # span (utils.profiling)


@span(MIX)
def mix(world, draws, T=2500):
    """Decorrelate envs by random-walking them T steps: each step plays a
    uniform valid action per env, drawn as argmax(logits + Gumbel) from
    `draws.gumbel`. Runs on the world's device."""
    for _ in range(T):
        valid = world.valid
        logits = torch.where(valid, 0.0, -torch.inf)
        actions = torch.argmax(logits + draws.gumbel(valid.shape), -1)
        world, _ = world.step(actions)
    return world


def present_value(deltas, fallback, terminal, alpha):
    """Reverse recursion over the leading (time) axis: result[T-1] =
    fallback[T-1]; result[t] = fallback[t] if terminal[t] else deltas[t] +
    alpha*result[t+1] (reference learning.py:57-68). The JAX package's
    reverse `lax.scan` is a reverse loop over T here."""
    nxt = fallback[-1]
    out = [nxt]
    for t in range(fallback.shape[0] - 2, -1, -1):
        nxt = torch.where(terminal[t], fallback[t], deltas[t] + alpha * nxt)
        out.append(nxt)
    return torch.stack(out[::-1])


def reward_to_go(reward, value, terminal, gamma=1.0):
    """Value targets: accumulated rewards bootstrapped with the network value
    at the end of the window, cut at terminals (reference learning.py:70-76).
    reward/value/terminal: (T, ...) with matching shapes."""
    fallback = torch.where(terminal, reward, value)
    return present_value(reward[:-1], fallback, terminal, gamma)


def rel_entropy(logits):
    """(mean policy entropy, mean log #valid-actions): the pair whose ratio is
    the relative-entropy stat (reference learning.py:19-24)."""
    valid = logits > -torch.inf
    zeros = torch.zeros_like(logits)
    l = torch.where(valid, logits, zeros)
    probs = torch.where(valid, torch.exp(l), zeros)
    return (-(l * probs).sum(-1).mean(),
            torch.log(valid.sum(-1).to(torch.float32)).mean())


def noise_scale(batch_size, optimizer):
    """Gradient noise-scale estimate from Adam's first and second moments
    (reference learning.py:26-41), read from a `torch.optim.Adam`'s state:
    `step`, `exp_avg` and `exp_avg_sq` are optax's `count`, `mu` and `nu`.
    `batch_size` is the whole batch's: on a data-parallel rank, every
    rank's envs (`train_step` passes `cfg.n_envs`). NaN before the first
    step."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    states = [optimizer.state[p] for p in params if p in optimizer.state]
    if not states:
        return torch.tensor(torch.nan)
    beta1, beta2 = 0.9, 0.999
    step = states[0]["step"]
    m_bias = 1 - beta1 ** step
    v_bias = 1 - beta2 ** step
    m = torch.cat([s["exp_avg"].reshape(-1) for s in states]) / m_bias
    v = torch.cat([s["exp_avg_sq"].reshape(-1) for s in states]) / v_bias
    inflator = (1 - beta1 ** 2) / (1 - beta1) ** 2
    S = batch_size * (v.mean() - torch.square(m).mean())
    G2 = inflator * torch.square(m).mean()
    return S / G2
