"""Carry weights, optimizer state and train state of the JAX package into
the port's.

`from_flax` takes the flax parameter tree as nested dicts of numpy arrays
(`{'params': {'intake': {'Dense_0': {'kernel', 'bias'}}, 'block_i': {...,
'alpha'}, 'policy': ..., 'value': ...}}`, or the inner 'params' dict) and
returns a state dict for `networks.FCModel`; a tree that holds only some of
these keys gives the entries of those. A flax Dense kernel is (in, out) and
a torch Linear weight is (out, in), so kernels are transposed. The intake
layouts are the heads' (models/heads.py): `intake/Dense_0` (Tensor,
Vector), `intake/bias` (Empty), and `intake/intake_{k}/...` plus
`intake/Dense_0` (a dict of spaces, each key's intake under `intakes.{k}`).
The Tensor intake flattens the channels-last (B,S,S,2) observation in C
order on both sides, so its kernel rows keep their order. The parameters
are float32 under either compute dtype.

`adam_from_optax` carries an `optax.adam` state (count, mu, nu) into a
`torch.optim.Adam` (step, exp_avg, exp_avg_sq); `adam_from_leaves` rebuilds
that state from the flat `jax.tree.leaves(opt_state)` list that the JAX
package's checkpoints hold (`boardlaw_tpu/train.py` `state_dict`);
`flax_order` lists a model's parameters in the leaf order of the flax tree
`from_flax` reads (what `jax.tree.leaves(params)` gives), each with
whether its flax leaf is its transpose. `train_state_from_jax`
carries a whole JAX `TrainState` (worlds, buffer, ptr, params, optimizer
state, step) into a port `train.TrainState`. The JAX objects come in as they
are or with their leaves turned into numpy arrays: only attributes and
arrays are read, nothing is imported from JAX.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def _dense(tree, prefix):
    d = tree["Dense_0"]
    return {
        f"{prefix}.dense.weight": torch.tensor(np.asarray(d["kernel"], np.float32).T),
        f"{prefix}.dense.bias": torch.tensor(np.asarray(d["bias"], np.float32)),
    }


def _intake(tree, prefix):
    """An intake's entries, for every layout of `heads.intake_module`."""
    sd = {}
    if "bias" in tree:
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(tree["bias"], np.float32))
    for k, sub in tree.items():
        if k.startswith("intake_"):
            sd.update(_intake(sub, f"{prefix}.intakes.{k[len('intake_'):]}"))
    if "Dense_0" in tree:
        sd.update(_dense(tree, prefix))
    return sd


def from_flax(params):
    tree = params.get("params", params)
    sd = _intake(tree["intake"], "intake") if "intake" in tree else {}
    depth = sum(1 for k in tree if k.startswith("block_"))
    for i in range(depth):
        block = tree[f"block_{i}"]
        sd.update(_dense(block, f"blocks.{i}"))
        sd[f"blocks.{i}.alpha"] = torch.tensor(np.asarray(block["alpha"], np.float32))
    for head in ("policy", "value"):
        if head in tree:
            sd.update(_dense(tree[head], head))
    return sd


def _flax_path(name):
    """The flax tree path of a parameter named as `from_flax` names it, and
    whether the flax leaf is its transpose (a Dense kernel)."""
    parts = name.split(".")
    path = []
    while parts:
        head = parts.pop(0)
        if head == "blocks":
            path.append(f"block_{parts.pop(0)}")
        elif head == "intakes":
            path.append(f"intake_{parts.pop(0)}")
        elif head == "dense":
            leaf = parts.pop(0)
            path += ["Dense_0", "kernel" if leaf == "weight" else "bias"]
            return tuple(path), leaf == "weight"
        else:
            path.append(head)
    return tuple(path), False


def flax_order(model):
    """[(name, parameter, transposed)] of a model's parameters in flax leaf
    order: the paths' keys sorted at every level."""
    named = [(_flax_path(n), n, p) for n, p in model.named_parameters()]
    return [(n, p, t) for (_, t), n, p in sorted(named, key=lambda x: x[0][0])]


def _tensor(x, device=None):
    """A numpy (or numpy-convertible) array as a tensor; bf16 arrays go
    through f32, which holds them exactly."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(x, device=device)


def _adam_state(opt_state):
    """The `ScaleByAdamState` (the element with `mu`) of an optax state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def adam_from_optax(opt_state, model, optimizer):
    """Set `optimizer` (a torch Adam over `model.parameters()`) to the optax
    adam state: optax `count`/`mu`/`nu` become torch `step`/`exp_avg`/
    `exp_avg_sq`, with the moments laid out as `from_flax` lays out the
    weights. Returns the optimizer."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax adam state (an element with mu/nu) in opt_state")
    mu, nu = from_flax(adam.mu), from_flax(adam.nu)
    step = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device).reshape(p.shape),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape),
        }
    return optimizer


def _sorted_leaves(tree, path=()):
    """(path, leaf) pairs of nested dicts in `jax.tree.leaves` order: the
    keys of every dict sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def adam_from_leaves(params, leaves):
    """The optax adam state of `optax.adam(lr)` from its flat leaves list:
    `(ScaleByAdamState(count, mu, nu), EmptyState())` flattens to count,
    then mu's leaves, then nu's, each in the leaf order of `params` (the
    flax tree the moments mirror). -> an object with `count`, `mu`, `nu`
    for `adam_from_optax`."""
    paths = [p for p, _ in _sorted_leaves(params)]
    n = len(paths)
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"an adam state over {n} parameters has {1 + 2 * n} leaves, "
                         f"got {len(leaves)}")

    def unflatten(values):
        out = {}
        for path, v in zip(paths, values):
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = v
        return out

    return SimpleNamespace(count=leaves[0], mu=unflatten(leaves[1:1 + n]),
                           nu=unflatten(leaves[1 + n:]))


def train_state_from_jax(jstate, cfg, device=None):
    """A port `train.TrainState` equal to the JAX package's `jstate` for
    `cfg` (a port `train.TrainConfig`): the next `train_step` of each, fed
    the same draws, computes the same step."""
    from .. import train
    from ..envs import hex
    from ..utils import resolve_device

    device = resolve_device(device)

    def world(jw):
        return hex.Hex(board=_tensor(jw.board, device), seats=_tensor(jw.seats, device))

    buffer = {k: _tensor(v, device) for k, v in jstate.buffer.items() if k != "worlds"}
    buffer["worlds"] = world(jstate.buffer["worlds"])
    model = train.build_model(cfg, device=device)
    model.load_state_dict(from_flax(jstate.params))
    optimizer = adam_from_optax(jstate.opt_state, model,
                                train.make_optimizer(cfg, model.parameters()))
    return train.TrainState(worlds=world(jstate.worlds), buffer=buffer,
                            ptr=int(np.asarray(jstate.ptr)), model=model, optimizer=optimizer,
                            step=int(np.asarray(jstate.step)))
