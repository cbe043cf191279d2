"""The network is a seam of the harness: a configuration's `net` names its
module under `reference/nets/`, and the weights, the reference, the work
counts and the CPU shrink go through it.

The FC network through the seam reads what the harness read before it had
one: the weights, the work and every cell's checks, against the formulas
inlined here as they were. And a stub network with a buffer, found through
the seam alone, runs as a self-play cell end to end: correct, its control
and faults not, its buffer the same on both sides after the learner's
train-mode steps."""
import math
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import check, harness, spec, weights, work
from benchmark.reference import nets
from benchmark.reference.nets import fc
from benchmark.tests import stub_net
from benchmark.tests.conftest import WORKLOADS, shrink, tiny

SEED = 4_000_000_017
CONFIGS = sorted({spec.cell(w).config_name: w for w in WORKLOADS}.items())


# ---- the parent's FC network, weights and work, inlined ----

def _old_layout(boardsize, width, depth):
    obs, A = 2 * boardsize * boardsize, boardsize * boardsize
    out = [("intake.dense.weight", (width, obs), "weight"), ("intake.dense.bias", (width,), "bias")]
    for i in range(depth):
        out += [(f"blocks.{i}.alpha", (), "alpha"),
                (f"blocks.{i}.dense.weight", (width, width), "weight"),
                (f"blocks.{i}.dense.bias", (width,), "bias")]
    out += [("policy.dense.weight", (A, width), "weight"), ("policy.dense.bias", (A,), "bias"),
            ("value.dense.weight", (1, width), "weight"), ("value.dense.bias", (1,), "bias")]
    return out


def _old_make(cfg, seed, device="cpu"):
    leaves = _old_layout(cfg["boardsize"], cfg["width"], cfg["depth"])
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, kind), x in zip(leaves, flat.split(sizes)):
        scale = {"bias": 0.1, "alpha": 0.5}.get(kind) or 1 / math.sqrt(shape[-1])
        out[name] = (x * scale).view(shape)
    return out


def _old_dense(x, p, name, prec):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if prec in ("float32", "tf32"):
        return F.linear(x, w, b)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec == "float8":
        x, w = nets.Float8.apply(x), nets.Float8.apply(w)
    return F.linear(x, w) + b.to(torch.bfloat16)


def _old_forward(p, obs, valid, seats, depth, prec="float32"):
    dt = torch.float32 if prec in ("float32", "tf32") else torch.bfloat16
    with nets.precision(prec):
        x = _old_dense(obs.reshape(obs.shape[0], -1), p, "intake.dense", prec)
        for i in range(depth):
            block = _old_dense(torch.relu(x), p, f"blocks.{i}.dense", prec)
            x = x + p[f"blocks.{i}.alpha"].to(dt) * block
        y = _old_dense(x, p, "policy.dense", prec).float()
        v = torch.tanh(_old_dense(x, p, "value.dense", prec).float()[:, 0])
    ninf = torch.tensor(-torch.inf, device=y.device)
    y = torch.where(valid, y, ninf)
    z = torch.where(valid, y - y.max(-1, keepdim=True).values, ninf)
    lse = torch.log(torch.where(valid, torch.exp(z), 0.0).sum(-1, keepdim=True))
    logits = torch.where(valid, z - lse, ninf)
    mover = seats.long()[:, None] == torch.arange(2, device=v.device)[None]
    return logits, torch.where(mover, v[:, None], -v[:, None])


def _old_weights(cfg):
    S, W, D = cfg["boardsize"], cfg["width"], cfg["depth"]
    obs, A = 2 * S * S, S * S
    return (obs + 1) * W + D * (W + 1) * W + (W + 1) * A + (W + 1)


class _OldFC:
    """The parent's network behind the seam's interface."""

    @staticmethod
    def layout(cfg):
        return _old_layout(cfg["boardsize"], cfg["width"], cfg["depth"])

    @staticmethod
    def draw(x, shape, kind):
        return x * ({"bias": 0.1, "alpha": 0.5}.get(kind) or 1 / math.sqrt(shape[-1]))

    @staticmethod
    def forward(p, obs, valid, seats, cfg, prec="float32", train=False):
        return _old_forward(p, obs, valid, seats, cfg["depth"], prec)

    macs = staticmethod(_old_weights)
    tiny = staticmethod(fc.tiny)


# ---- the FC network reads what it read before the seam ----

@pytest.mark.parametrize("seed", [1, 2_184_000_516, SEED])
@pytest.mark.parametrize("config, workload", CONFIGS, ids=[c for c, _ in CONFIGS])
def test_fc_weights_are_the_parents_formula(config, workload, seed):
    cfg = spec.cell(workload).config
    assert "net" not in cfg and nets.module(cfg) is fc
    new, old = weights.make(cfg, seed, "cpu"), _old_make(cfg, seed)
    assert list(new) == list(old)
    assert all(torch.equal(new[k], old[k]) for k in old)


@pytest.mark.parametrize("prec", ["float32", "tf32", "bfloat16", "float8"])
def test_fc_forward_is_the_parents(prec):
    cfg = fc.tiny(dict(spec.cell("hex9_512x4.selfplay").config, boardsize=5))
    p = weights.make(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    obs = (torch.rand((12, 5, 5, 2), generator=g) < 0.3).float()
    valid = torch.rand((12, 25), generator=g) < 0.8
    seats = torch.randint(0, 2, (12,), generator=g)
    for train in (False, True):
        for a, b in zip(fc.forward(dict(p), obs, valid, seats, cfg, prec, train),
                        _old_forward(p, obs, valid, seats, cfg["depth"], prec)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", WORKLOADS)
def test_work_is_the_parents_formula(name):
    cfg = spec.cell(name).config
    old = _old_weights(cfg)
    assert work.macs(cfg) == old
    assert work.train_step_flops(cfg) == old * cfg["n_envs"] * (2 * work.evaluations(cfg) + 6)
    assert work.search_flops(cfg, 1024) == 2 * old * 1024 * work.evaluations(cfg)
    # the bytes never read the network: the parent's numbers at the cells' sizes
    want = {"hex9_512x4": 8_866_234_432, "hex6_128x1": 24_648_745_464,
            "hex9_512x4_bf16": 8_866_234_432 - 2 * 32768 * 81 * 296}
    assert work.search_bytes(cfg, cfg["n_envs"]) == want[spec.cell(name).config_name]


@pytest.mark.parametrize("name", WORKLOADS)
def test_tiny_checks_are_the_parents(name, monkeypatch):
    """Each cell's CPU checks, through the seam and through the parent's
    network put behind it, equal bit for bit."""
    runs = []
    for seam in (nets.module, lambda cfg: _OldFC):
        monkeypatch.setattr(nets, "module", seam)
        r = harness.run(name, SEED, 0.5, False, time.perf_counter(), device="cpu",
                        cell=tiny(name))
        runs.append({k: c["value"] for k, c in r["checks"].items()})
    assert runs[0] == runs[1]


# ---- a network with a buffer, found through the seam alone ----

def _program_model():
    """The stub's counterpart in the program: the port's FC model over
    observations less their mean, the batch's where the forward has a
    gradient (the learner), its running mean `obs_mean` otherwise (the
    searches)."""
    from boardlaw_tpu_torch.envs import hex
    from boardlaw_tpu_torch.models.networks import FCModel

    class Centred(FCModel):
        def __init__(self, obs_space, *args, **kwargs):
            super().__init__(obs_space, *args, **kwargs)
            dev = next(self.parameters()).device
            self.register_buffer("obs_mean", torch.zeros(tuple(obs_space.dim), device=dev))

        def forward(self, obs, valid, seats):
            if torch.is_grad_enabled():
                mean = obs.mean(0)
                with torch.no_grad():
                    self.obs_mean.mul_(1 - stub_net.MOMENTUM).add_(stub_net.MOMENTUM * mean)
            else:
                mean = self.obs_mean
            return super().forward(obs - mean, valid, seats)

    def build(cfg, device=None, generator=None):
        world = hex.Hex.initial(1, cfg.boardsize, device="cpu")
        return Centred(world.obs_space, world.action_space, width=cfg.width, depth=cfg.depth,
                       n_seats=world.n_seats, dtype=cfg.compute_dtype, device=device,
                       generator=generator)

    return build


def _namespace():
    """id of every attribute of every loaded module of the benchmark."""
    return {name: {k: id(v) for k, v in vars(mod).items()} for name, mod in list(sys.modules.items())
            if name.startswith("benchmark.") and ".tests" not in name}


def test_a_network_with_a_buffer_runs_through_the_seam(monkeypatch):
    from boardlaw_tpu_torch import train

    from benchmark.kinds import selfplay as sp

    name = "hex9_512x4.selfplay"
    before = _namespace()
    monkeypatch.setitem(sys.modules, f"{nets.__name__}.stub", stub_net)
    monkeypatch.setattr(train, "build_model", _program_model())
    cell = spec.cell(name)
    cell.config["net"] = "stub"
    shrink(cell)
    cpu = torch.device("cpu")
    assert nets.module(cell.config) is stub_net
    w0 = weights.make(cell.config, SEED, cpu)
    assert nets.buffers(stub_net.layout(cell.config)) == ["obs_mean"] and w0["obs_mean"].any()
    assert work.macs(cell.config) == fc.macs(cell.config)

    result = harness.run(name, SEED, 0.5, False, time.perf_counter(), device="cpu", cell=cell)
    assert result["correct"], result["checks"]

    # the buffer after the checked steps: moved by the learner, the same on
    # both sides; grad and change over the trainable leaves alone
    _, _, _, rec = sp.set_up(cell, SEED, cpu)
    ref = sp.reference_outputs(cell, SEED, cpu, rec)
    assert set(rec["buffers"]) == set(ref["buffers"]) == {"obs_mean"}
    assert not torch.equal(ref["buffers"]["obs_mean"], w0["obs_mean"])
    torch.testing.assert_close(rec["buffers"]["obs_mean"], ref["buffers"]["obs_mean"],
                               rtol=1e-6, atol=1e-7)
    assert "obs_mean" not in ref["grad"] and "obs_mean" not in ref["change"]
    assert set(ref["change"]) == set(rec["change"])

    limits = check.limits(name)
    out = cell.kind().control(cell, SEED, cpu, 1.0)
    assert check.judge(out["program"], limits)[0], out["program"]
    assert out["program"]["buffers"] < 1e-6
    for kind in ("control", "answer", "half"):
        assert not check.judge(out[kind], limits)[0], (kind, out[kind])

    # the stub took no edit of the benchmark: nothing of it was patched
    after = _namespace()
    assert {k: after[k] for k in before} == before
