"""A stub network with a buffer, for the seam's test, written as a module
under `benchmark/reference/nets/` would be: the FC network (`nets.fc`) over
observations less their mean. The learner's train-mode forward takes the
batch's mean and moves a running mean (`obs_mean`, a buffer) toward it by
`MOMENTUM`, as batch norm moves its running statistics; the searches take
the running mean."""
from __future__ import annotations

from benchmark.reference import nets
from benchmark.reference.nets import fc

MOMENTUM = 0.1


def layout(cfg):
    S = cfg["boardsize"]
    return fc.layout(cfg) + [("obs_mean", (S, S, 2), nets.BUFFER)]


def draw(x, shape, kind):
    return 0.1 * x if kind == nets.BUFFER else fc.draw(x, shape, kind)


def forward(p, obs, valid, seats, cfg, prec="float32", train=False):
    if train:
        mean = obs.mean(0)
        p["obs_mean"] = (1 - MOMENTUM) * p["obs_mean"] + MOMENTUM * mean
    else:
        mean = p["obs_mean"]
    return fc.forward(p, obs - mean, valid, seats, cfg, prec)


macs = fc.macs
tiny = fc.tiny
