"""AlphaGo Zero's network (Silver et al. 2017, Mastering the game of Go
without human knowledge, Nature 550:354, Methods, "Neural network
architecture"), the port's `AZTower`: a conv 3x3 `width` + batch norm +
ReLU intake; `depth` residual blocks, each conv 3x3 + BN + ReLU + conv 3x3
+ BN, the block's input added, ReLU; a policy head of conv 1x1 (2 filters)
+ BN + ReLU and a dense layer to the move logits; a value head of conv 1x1
(1 filter) + BN + ReLU, dense `HIDDEN` + ReLU, dense 1 and tanh.

Departures from the paper:

- the input is Hex's 2 planes in the mover's frame (own stones, the
  opponent's), not Go's 17: Hex has no ko, so no history planes and no
  colour plane;
- 81 logits on 9x9, no pass move;
- the learner has no L2 term (the port's learner is Adam without decay;
  AGZ used SGD with momentum and c = 1e-4);
- batch norm's momentum 0.1 and eps 1e-5 (PyTorch's defaults; the paper
  gives neither), its variance biased in the normalisation and unbiased in
  the running statistic, as `F.batch_norm` keeps it; the convolutions have
  no bias, the batch norm after each supplies the shift;
- the products in bfloat16 where the configuration says so.

Layout: the port's state-dict names. The heads' convolution features are
flattened position-major (the channels-last order). Batch norm is
`F.batch_norm` over (N, H, W): in train mode (the learner's) the batch's
mean and biased variance normalise, and the running statistics move toward
the batch's mean and unbiased variance, written into `p` as new tensors; in
eval mode (every search) the running statistics normalise. In "bfloat16"
and "float8" the inputs and weights of every convolution and dense layer,
the batch norms' outputs and the residual sums are bf16, and batch norm
computes in float32 from the bf16 input with float32 statistics and affine
parameters; "float8" rounds every convolution's and dense layer's input and
weight through float8_e4m3fn first.

Leaves are drawn as weights scaled by 1/sqrt(fan-in) (c_in k k for a
convolution), biases by 0.1, batch norm's scales and shifts as 1 + x/10 and
its running statistics as exp(x/10): a running variance is positive, and
the shift near 1 offsets the running mean near 1, so that a search's
eval-mode batch norm passes about half of each ReLU's inputs, as the
learner's train mode does, and neither side's policy is uniform."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import BUFFER, Float8, compute_dtype, outputs, precision

HIDDEN = 256  # the value head's hidden layer, as published
MOMENTUM, EPS = 0.1, 1e-5


def _bn(name, n):
    return [(f"{name}.weight", (n,), "bn"), (f"{name}.bias", (n,), "bn"),
            (f"{name}.running_mean", (n,), BUFFER), (f"{name}.running_var", (n,), BUFFER)]


def _conv_bn(name, c_in, c_out, k):
    return [(f"{name}.conv.weight", (c_out, c_in, k, k), "conv")] + _bn(f"{name}.bn", c_out)


def layout(cfg):
    """Kinds "conv" (fan-in c_in k k), "weight" (fan-in the last axis),
    "bias", "bn" (batch norm's scale and shift) and the buffers."""
    S, W = cfg["boardsize"], cfg["width"]
    out = _conv_bn("intake", 2, W, 3)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        out += [(f"{b}.conv1.weight", (W, W, 3, 3), "conv")] + _bn(f"{b}.bn1", W)
        out += [(f"{b}.conv2.weight", (W, W, 3, 3), "conv")] + _bn(f"{b}.bn2", W)
    out += _conv_bn("policy_conv", W, 2, 1)
    out += [("policy.dense.weight", (S * S, 2 * S * S), "weight"),
            ("policy.dense.bias", (S * S,), "bias")]
    out += _conv_bn("value_conv", W, 1, 1)
    out += [("value_hidden.weight", (HIDDEN, S * S), "weight"),
            ("value_hidden.bias", (HIDDEN,), "bias"),
            ("value.dense.weight", (1, HIDDEN), "weight"), ("value.dense.bias", (1,), "bias")]
    return out


def draw(x, shape, kind):
    if kind == BUFFER:
        return torch.exp(0.1 * x)
    if kind == "bn":
        return 1 + 0.1 * x
    if kind == "bias":
        return 0.1 * x
    return x / math.sqrt(math.prod(shape[1:]))


def _in(x, w, prec):
    """A product's input and weight in the precision's type."""
    if prec in ("float32", "tf32"):
        return x, w
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec == "float8":
        x, w = Float8.apply(x), Float8.apply(w)
    return x, w


def _conv2d(x, p, name, prec):
    w = p[name + ".weight"]
    x, w = _in(x, w, prec)
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _dense(x, p, name, prec):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if prec in ("float32", "tf32"):
        return F.linear(x, w, b)
    x, w = _in(x, w, prec)
    return F.linear(x, w) + b.to(torch.bfloat16)


def _batch_norm(x, p, name, train):
    """Over the channels of (N,C,H,W) x; the output in x's type."""
    rm, rv = name + ".running_mean", name + ".running_var"
    stats = p[rm].clone(), p[rv].clone()
    y = F.batch_norm(x, *stats, p[name + ".weight"], p[name + ".bias"], train, MOMENTUM, EPS)
    p[rm], p[rv] = stats
    return y


def _flat(x):
    """(N,C,S,S) -> (N, S*S*C), position-major."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def forward(p, obs, valid, seats, cfg, prec="float32", train=False):
    dt = compute_dtype(prec)

    def conv_bn(x, conv, bn):
        return _batch_norm(_conv2d(x, p, conv, prec), p, bn, train)

    with precision(prec):
        x = obs.permute(0, 3, 1, 2).to(dt)
        x = torch.relu(conv_bn(x, "intake.conv", "intake.bn"))
        for i in range(cfg["depth"]):
            b = f"blocks.{i}"
            y = torch.relu(conv_bn(x, f"{b}.conv1", f"{b}.bn1"))
            x = torch.relu(x + conv_bn(y, f"{b}.conv2", f"{b}.bn2"))
        pol = _flat(torch.relu(conv_bn(x, "policy_conv.conv", "policy_conv.bn")))
        y = _dense(pol, p, "policy.dense", prec).float()
        val = _flat(torch.relu(conv_bn(x, "value_conv.conv", "value_conv.bn")))
        hidden = torch.relu(_dense(val, p, "value_hidden", prec))
        v = torch.tanh(_dense(hidden, p, "value.dense", prec).float()[:, 0])
    return outputs(y, v, valid, seats)


def conv_macs(cfg):
    """The convolutions' multiply-adds of one evaluation: each weight at
    every one of the S*S output positions."""
    S, W, D = cfg["boardsize"], cfg["width"], cfg["depth"]
    return S * S * (2 * W * 9 + D * 2 * W * W * 9 + W * 2 + W * 1)


def macs(cfg):
    """The convolutions' (`conv_macs`) and the dense layers' weights and
    biases, as `fc.py` counts them; batch norm not counted (an affine map a
    channel, which folds into the convolution before it)."""
    S = cfg["boardsize"]
    A = S * S
    return conv_macs(cfg) + (2 * A + 1) * A + (A + 1) * HIDDEN + (HIDDEN + 1)


def tiny(cfg):
    return dict(cfg, width=8, depth=2)
