"""AlphaGo Zero's residual tower in the port (`networks.AZTower`,
`TrainConfig.net="az"`) on the CPU, held against the benchmark's plain
reference (`benchmark/reference/nets/az.py`) on weights drawn from a seed by
`benchmark.weights.make`, at boardsize 5 (9 for the benchmark's loop),
width 8, depth 2. The JAX package has no such network.

* The forward, in eval mode (the searches: running statistics) and train
  mode (the learner: the batch's, moving the running ones), at float32 to
  atol 1e-6 and at bfloat16 to the tolerance of `test_torch_bf16.py`'s
  eager comparison (logits 1.9e-6, v 2.4e-7: float32 roundoff of the
  float32 heads; both sides round to bf16 after the same ops, so what is
  left is the heads' float32 arithmetic).
* The gradient of `train.losses` against the reference's loss, and the
  running statistics after it; `losses` leaves the model in eval mode.
* The running statistics after one learner step of the benchmark's loop,
  program against reference.
* The state dict's names and shapes are the reference's `layout`, the
  running statistics its buffers.
* `storage.flops_per_sample`: today's count for the FC nets (one
  multiply-add a weight, as in JAX: it sets the FC runs' savepoints), the
  reference's `macs` x nodes for the tower.
* The normal path: `make_train` -> `train_step`; `train.run` writes a
  checkpoint with the buffers, resumes from it, and the run's agent plays
  a move in the arena; a JAX checkpoint is refused; with tracing on the
  `net.*` spans sit under both `search.eval` and `train.learner`, and
  `net.train_forward` counts the learner's forward alone.
"""
import pytest
import torch

from benchmark import weights
from benchmark.kinds import selfplay as sp
from benchmark.reference import hex as ref_hex, learner as ref_learner, nets
from benchmark.reference.nets import az
from benchmark.tests.conftest import tiny
from boardlaw_tpu_torch import storage, train
from boardlaw_tpu_torch.arena import common
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.models import networks
from boardlaw_tpu_torch.pavlov import runs, storage as pstorage
from boardlaw_tpu_torch.pavlov.tests import mock_dir
from boardlaw_tpu_torch.utils import profiling

SEED = 4_000_000_017
CFG = {"boardsize": 5, "width": 8, "depth": 2, "net": "az"}
# (logits, v) atol: float32; bfloat16 as test_torch_bf16.py's eager case
TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1.9e-6, 2.4e-7)}
PRECS = sorted(TOL)


def _boards(B=24, plies=6, seed=1):
    g = torch.Generator().manual_seed(seed)
    S = CFG["boardsize"]
    board = torch.full((B, S, S), ref_hex.EMPTY, dtype=torch.uint8)
    seats = torch.zeros(B, dtype=torch.int32)
    for _ in range(plies):
        valid = ref_hex.valid(board, seats)
        noise = torch.rand(valid.shape, generator=g)
        board, seats, _, _ = ref_hex.step(board, seats, torch.where(valid, noise, -1.0).argmax(-1))
    return board, seats


def _model(prec):
    cfg = train.make_config(5, 8, 2, net="az", dtype=prec)
    model = train.build_model(cfg, device="cpu")
    p = weights.make(CFG, SEED, "cpu")
    model.load_state_dict(p)
    return model, p


def _close(got, want, atol, what):
    torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=what)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("prec", PRECS)
def test_forward_is_the_references(prec, train_mode):
    model, p = _model(prec)
    board, seats = _boards()
    obs, valid = ref_hex.observe(board, seats), ref_hex.valid(board, seats)
    ref = dict(p)
    logits, v = az.forward(ref, obs, valid, seats, CFG, prec, train_mode)
    model.train(train_mode)
    with torch.no_grad():
        out = model(thex._observe(board, seats), valid, seats)
    atol_l, atol_v = TOL[prec]
    assert out["logits"].dtype == out["v"].dtype == torch.float32
    assert torch.equal(torch.isneginf(out["logits"]), torch.isneginf(logits))
    _close(out["logits"][valid], logits[valid], atol_l, "logits")
    _close(out["v"], v, atol_v, "v")
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(nets.buffers(az.layout(CFG)))
    for k, b in buffers.items():
        # eval mode leaves them as drawn; train mode moves both sides alike
        _close(b, ref[k], 1e-7, k)
        assert torch.equal(b, p[k]) != train_mode, k


@pytest.mark.parametrize("prec", PRECS)
def test_losses_gradient_is_the_references(prec):
    model, p = _model(prec)
    board, seats = _boards(B=32, plies=8, seed=2)
    g = torch.Generator().manual_seed(3)
    valid = ref_hex.valid(board, seats)
    targets = torch.log_softmax(torch.where(valid, torch.randn(valid.shape, generator=g),
                                            -torch.inf), -1).to(torch.bfloat16)
    rtg = torch.randn((32, 2), generator=g).clamp(-1, 1)
    batch = {"worlds": thex.Hex(board=board, seats=seats), "logits": targets,
             "prior": targets, "reward_to_go": rtg}
    loss, aux, _ = train.losses(model, batch)
    loss.backward()
    assert not model.training

    trained = nets.trainable(az.layout(CFG))
    leaves = {k: p[k].detach().clone().requires_grad_(k in trained) for k in p}
    with nets.precision(prec):
        policy, value = ref_learner.losses(CFG, leaves, {"board": board, "seats": seats,
                                                         "logits": targets,
                                                         "reward_to_go": rtg}, prec)
        grads = torch.autograd.grad(policy + value, [leaves[k] for k in trained])
    _close(aux["loss.policy"], policy.detach(), 1e-5, "policy loss")
    _close(aux["loss.value"], value.detach(), 1e-6, "value loss")
    named = dict(model.named_parameters())
    assert set(named) == set(trained)
    for k, want in zip(trained, grads):
        _close(named[k].grad, want, 2e-5 * max(1.0, float(want.abs().max())), k)
    for k, b in model.named_buffers():
        _close(b, leaves[k], 1e-7, k)
        assert not torch.equal(b, p[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_running_statistics_after_a_learner_step_are_the_references(dtype):
    cell = tiny("hex9_az20x256_bf16.selfplay")
    cell.config.update(dtype=dtype, tree_dtype=dtype)
    cell.traffic.update(check_steps=1)
    cpu = torch.device("cpu")
    w0 = weights.make(cell.config, SEED, cpu)
    _, _, _, rec = sp.set_up(cell, SEED, cpu)
    ref = sp.reference_outputs(cell, SEED, cpu, rec, sp.precision(cell.config))
    assert set(rec["buffers"]) == set(ref["buffers"]) == set(nets.buffers(az.layout(cell.config)))
    for k, b in ref["buffers"].items():
        assert not torch.equal(b, w0[k]), k
        _close(rec["buffers"][k], b, 1e-6, k)


@pytest.mark.parametrize("size", [(5, 8, 2), (9, 16, 3), (9, 256, 19)], ids=str)
def test_state_dict_names_are_the_layout(size):
    S, W, D = size
    model = train.build_model(train.make_config(S, W, D, net="az"), device="cpu")
    layout = az.layout({"boardsize": S, "width": W, "depth": D})
    sd = model.state_dict()
    assert list(sd) == [name for name, _, _ in layout]
    assert all(tuple(sd[name].shape) == shape for name, shape, _ in layout)
    assert [n for n, _ in model.named_buffers()] == nets.buffers(layout)
    assert [n for n, _ in model.named_parameters()] == nets.trainable(layout)
    assert not model.training and model.intake.conv.weight.is_contiguous(
        memory_format=torch.channels_last)


# the FC counts set the FC runs' savepoints; pinned at the paper's 9x9 and
# 6x6 agents, one multiply-add a weight, as the JAX package counts them
FLOPS = [("fc", 9, 512, 4, 64 * 1_176_146), ("fc", 6, 128, 1, 64 * 30_629),
         ("az", 9, 256, 19, 64 * 1_815_948_180), ("az", 5, 8, 2, None)]


@pytest.mark.parametrize("net, S, W, D, want", FLOPS, ids=[f"{n}{s}_{w}x{d}" for n, s, w, d, _ in FLOPS])
def test_flops_per_sample(net, S, W, D, want):
    model = train.build_model(train.make_config(S, W, D, net=net), device="cpu")
    cfg = {"boardsize": S, "width": W, "depth": D}
    got = storage.flops_per_sample(model, 64)
    if net == "az":
        assert got == 64 * az.macs(cfg) and az.conv_macs(cfg) < az.macs(cfg)
    assert want is None or got == want


def test_build_model_refuses_an_unknown_net():
    with pytest.raises(ValueError, match="no network"):
        train.build_model(train.make_config(5, 8, 2, net="resnet"), device="cpu")


def _config(**kw):
    return train.make_config(5, 8, 2, nodes=8, n_envs=8, buffer_len=3, mix_steps=5, net="az",
                             **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_through_the_normal_path(dtype):
    cfg = _config(dtype=dtype, tree_dtype=dtype)
    model, _, init, warmup, step = train.make_train(cfg, device="cpu")
    assert isinstance(model, networks.AZTower) and not model.training
    draws = Draws(0, "cpu")
    state = warmup(init(draws), draws)
    stats = {k: b.clone() for k, b in state.model.named_buffers()}
    weights0 = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    for _ in range(2):
        state, aux = step(state, draws)
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert not state.model.training
    assert all(not torch.equal(b, stats[k]) for k, b in state.model.named_buffers())
    assert any(not torch.equal(p, weights0[k]) for k, p in state.model.named_parameters())


def test_run_checkpoint_resume_and_arena_agent():
    kw = dict(n_envs=8, nodes=8, mix_steps=16, buffer_len=4, net="az", device="cpu")
    with mock_dir():
        run = train.run(5, 8, 2, max_steps=2, **kw)
        assert pstorage.load_raw(run, "model")["kind"] == "AZTower"
        sd = pstorage.load_latest(run)["agent"]
        assert set(nets.buffers(az.layout(CFG))) <= set(sd["params"])
        train.run(5, 8, 2, max_steps=4, resume=run, **kw)
        sd2 = pstorage.load_latest(run)["agent"]
        assert sd2["step"] == 4 and runs.list_runs() == [run]
        assert any(not torch.equal(torch.as_tensor(sd2["params"][k]),
                                   torch.as_tensor(sd["params"][k]))
                   for k in nets.buffers(az.layout(CFG)))

        agent = common.agent(run, device="cpu")
        assert isinstance(agent.model, networks.AZTower) and not agent.model.training
        world = common.worlds(run, 4, device="cpu")
        out = agent(world, Draws(0, "cpu"), eval=True)
        assert world.valid[torch.arange(4), out["actions"].long()].all()
        for k, b in agent.model.named_buffers():
            assert torch.equal(b, torch.as_tensor(sd2["params"][k])), k


def test_a_jax_checkpoint_is_refused_for_the_tower():
    cfg = _config()
    _, _, init, _, _ = train.make_train(cfg, device="cpu")
    state = init(Draws(0, "cpu"))
    with pytest.raises(ValueError, match="FC network"):
        train.load_state_dict(state, {"params": {}, "opt": [], "step": 0})


def _ancestors(records, rec):
    by_id = {r[3]: r for r in records}
    out, parent = [], rec[4]
    while parent in by_id:
        out.append(by_id[parent][0])
        parent = by_id[parent][4]
    return out


def test_spans_and_the_train_forward_counter():
    cfg = _config()
    _, _, init, warmup, step = train.make_train(cfg, device="cpu")
    draws = Draws(0, "cpu")
    state = warmup(init(draws), draws)
    was = profiling.enabled()
    profiling.enable()
    profiling.reset()
    try:
        state, _ = step(state, draws)
        records, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.enable(was)
        profiling.reset()
    nets_ = [r for r in records if r[0].startswith("net.")]
    assert {r[0] for r in nets_} == {networks.INTAKE, networks.TOWER, networks.HEADS}
    under = [_ancestors(records, r) for r in nets_ if r[0] == networks.TOWER]
    in_eval = sum("search.eval" in a or "search.root" in a for a in under)
    in_learner = sum(train.LEARNER in a for a in under)
    # the root's and every pass's evaluation, and the learner's forward once
    assert in_learner == 1 and in_eval == len(under) - 1 >= 2
    assert counters[networks.TRAIN_FORWARD] == 1
