"""Carry weights of the JAX package's flax `FCModel` into the port's.

`from_flax` takes the flax parameter tree as nested dicts of numpy arrays
(`{'params': {'intake': {'Dense_0': {'kernel', 'bias'}}, 'block_i': {...,
'alpha'}, 'policy': ..., 'value': ...}}`, or the inner 'params' dict) and
returns a state dict for `networks.FCModel`. A flax Dense kernel is
(in, out) and a torch Linear weight is (out, in), so kernels are transposed.
The intake flattens the channels-last (B,S,S,2) observation in C order on
both sides, so its kernel rows keep their order.
"""
from __future__ import annotations

import numpy as np
import torch


def _dense(tree, prefix):
    d = tree["Dense_0"]
    return {
        f"{prefix}.dense.weight": torch.tensor(np.asarray(d["kernel"], np.float32).T),
        f"{prefix}.dense.bias": torch.tensor(np.asarray(d["bias"], np.float32)),
    }


def from_flax(params):
    tree = params.get("params", params)
    sd = {}
    sd.update(_dense(tree["intake"], "intake"))
    depth = sum(1 for k in tree if k.startswith("block_"))
    for i in range(depth):
        block = tree[f"block_{i}"]
        sd.update(_dense(block, f"blocks.{i}"))
        sd[f"blocks.{i}.alpha"] = torch.tensor(np.asarray(block["alpha"], np.float32))
    sd.update(_dense(tree["policy"], "policy"))
    sd.update(_dense(tree["value"], "value"))
    return sd
