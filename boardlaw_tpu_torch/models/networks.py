"""Policy/value networks. Counterpart of boardlaw_tpu/models/networks.py: a
fully-connected ReZero residual tower over the observation, with a policy
head (masked softmax for Hex) and a tanh value head (`FCModel`); and, with
no JAX counterpart, AlphaGo Zero's convolutional residual tower with batch
norm (`AZTower`).

`dtype` is the compute type of every layer, float32 (the default) or
bfloat16 (the JAX flagship's): float32 parameters, the tower and its
residual sums in `dtype`, the heads' softmax and tanh in float32
(models/heads.py). Float32 runs with TF32 off for both matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`, set by both networks): TF32 keeps
about three decimal digits, and the JAX reference computes these products in
full float32. `AZTower`'s batch norm keeps its statistics, running
statistics and affine parameters in float32 and writes its output in
`dtype`.

A network is built in eval mode (`train.build_model`): the searches see
batch norm's running statistics, and `train.losses` switches it to the
batch's statistics around the learner's forward alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import heads
from ..utils import resolve_device
from ..utils.profiling import count, span

# spans and counter (utils.profiling)
INTAKE = "net.intake"
TOWER = "net.tower"
HEADS = "net.heads"
TRAIN_FORWARD = "net.train_forward"


class ReZeroResidual(nn.Module):
    """x + alpha * W relu(x) in `dtype` (alpha, float32, cast to it),
    alpha initialised to 0."""

    def __init__(self, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.dense = heads.Dense(width, width, dtype, init=heads.orthogonal_,
                                 generator=generator)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x + self.alpha.to(self.dtype) * self.dense(torch.relu(x))


class FCModel(nn.Module):
    """Intake -> depth x ReZero -> (masked policy, per-seat tanh value).

    Call with (obs, valid, seats); returns {'logits': (B,A) f32 log-probs with
    -inf at invalid actions, 'v': (B, n_seats) f32}. The intake and policy
    head are the spaces' (`heads.intake_module`, `heads.output_module`);
    `dtype` is the compute type (torch.float32 or torch.bfloat16). Weights
    are float32, made on the CPU from `generator` (or torch's default one)
    and then moved to `device`, so a seed gives the same weights on every
    device.
    """

    def __init__(self, obs_space, action_space, width=256, depth=64, n_seats=2,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.intake = heads.intake_module(obs_space, width, dtype, generator=generator)
        self.blocks = nn.ModuleList(
            [ReZeroResidual(width, dtype, generator=generator) for _ in range(depth)])
        self.policy = heads.output_module(action_space, width, dtype, generator=generator)
        self.value = heads.ValueOutput(width, n_seats, dtype, generator=generator)
        self.to(device)

    def forward(self, obs, valid, seats):
        x = self.intake(obs)
        for block in self.blocks:
            x = block(x)
        return {"logits": self.policy(x, valid), "v": self.value(x, valid, seats)}


# AlphaGo Zero's batch norm: PyTorch's defaults (the paper gives neither)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5
VALUE_HIDDEN = 256  # the value head's hidden layer, as published


class BatchNorm(nn.Module):
    """Batch norm over the channels of an NCHW tensor, through
    `F.batch_norm`: float32 affine parameters and running statistics
    (buffers `running_mean`, `running_var`; no `num_batches_tracked`). In
    train mode it normalises by the batch's statistics and moves the running
    ones by `BN_MOMENTUM` (the variance unbiased); in eval mode it normalises
    by the running ones. A bfloat16 input gives a bfloat16 output."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, BN_MOMENTUM, BN_EPS)


class Conv(nn.Conv2d):
    """A bias-free k x k convolution, stride 1, 'same' padding, as
    `heads.Dense` computes a product: float32 weights (lecun-normal over
    the fan-in c_in k k), cast to `dtype` with the input."""

    def __init__(self, c_in, c_out, k, dtype=torch.float32, generator=None):
        super().__init__(c_in, c_out, k, padding=k // 2, bias=False)
        self.dtype = dtype
        with torch.no_grad():
            heads.lecun_normal_(self.weight.view(c_out, -1), generator=generator)

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), None)


class ConvBN(nn.Module):
    """conv -> batch norm, without the ReLU."""

    def __init__(self, c_in, c_out, k, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, dtype, generator=generator)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        return self.bn(self.conv(x))


class AZResidual(nn.Module):
    """relu(x + BN(conv(relu(BN(conv(x)))))), the sum in `dtype`."""

    def __init__(self, width, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv1 = Conv(width, width, 3, dtype, generator=generator)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, dtype, generator=generator)
        self.bn2 = BatchNorm(width)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(x + self.bn2(self.conv2(y)))


class AZTower(nn.Module):
    """AlphaGo Zero's network (Silver et al. 2017, Methods, "Neural network
    architecture"): a conv 3x3 `width` + BN + ReLU intake, `depth` residual
    blocks of two such convolutions (`AZResidual`), a policy head (conv 1x1,
    2 filters, BN, ReLU, then `heads.MaskedOutput` over the 2 S S features)
    and a value head (conv 1x1, 1 filter, BN, ReLU, a dense `VALUE_HIDDEN`
    + ReLU, then `heads.ValueOutput`'s tanh and seat scatter).

    The convolutions have no bias (the batch norm after each supplies the
    shift). The input is Hex's two planes in the mover's frame, the
    channels-last (B,S,S,2) observation seen as NCHW through a permute, so
    the tower runs in `torch.channels_last` without a copy; its 4-d weights
    are kept channels-last too. The outputs are `FCModel`'s: (B,S*S) masked
    log-probs, no pass move, and (B, n_seats) values. `dtype` and the
    weights' generator are as for `FCModel`; batch norm follows the module's
    mode (`training`). `macs()` counts one evaluation's multiply-adds."""

    def __init__(self, obs_space, action_space, width=256, depth=19, n_seats=2,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        S, _, planes = obs_space.dim
        self.positions = S * S
        self.dtype = dtype
        self.intake = ConvBN(planes, width, 3, dtype, generator=generator)
        self.blocks = nn.ModuleList(
            [AZResidual(width, dtype, generator=generator) for _ in range(depth)])
        self.policy_conv = ConvBN(width, 2, 1, dtype, generator=generator)
        self.policy = heads.MaskedOutput(action_space, 2 * S * S, dtype, generator=generator)
        self.value_conv = ConvBN(width, 1, 1, dtype, generator=generator)
        self.value_hidden = heads.Dense(S * S, VALUE_HIDDEN, dtype, generator=generator)
        self.value = heads.ValueOutput(VALUE_HIDDEN, n_seats, dtype, generator=generator)
        self.to(device, memory_format=torch.channels_last)

    def forward(self, obs, valid, seats):
        if self.training:
            count(TRAIN_FORWARD)
        with span(INTAKE):
            x = torch.relu(self.intake(obs.permute(0, 3, 1, 2)))
        with span(TOWER):
            for block in self.blocks:
                x = block(x)
        with span(HEADS):
            p = _flat(torch.relu(self.policy_conv(x)))
            v = torch.relu(self.value_hidden(_flat(torch.relu(self.value_conv(x)))))
            return {"logits": self.policy(p, valid), "v": self.value(v, valid, seats)}

    def macs(self):
        """Multiply-adds of one evaluation: a convolution's weights at
        every output position, a dense layer's weights and biases; batch
        norm not counted."""
        convs = sum(m.weight.numel() for m in self.modules() if isinstance(m, Conv))
        dense = sum(m.weight.numel() + m.bias.numel() for m in self.modules()
                    if isinstance(m, heads.Dense))
        return convs * self.positions + dense


def _flat(x):
    """(B,C,S,S) channels-last -> (B, S*S*C), position-major: a view."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)



def make_eval_fn(model):
    """Close a model over its weights as a world evaluator:
    ``eval_fn(world) -> {'logits', 'v'}``, the interface MCTS consumes."""

    @torch.no_grad()
    def eval_fn(world):
        return model(world.obs, world.valid, world.seats)

    return eval_fn
