"""The port's training entry point `train.run` and its checkpoints, on the
CPU: the cases of tests/test_train.py (a tiny run and its resume, the
storer's seed, `flops_per_sample`) against the port, the port's checkpoint
round trip, and the resume of a checkpoint that the JAX package wrote
(flax msgpack: its flax params and the flat leaves of its optax adam state,
built from a JAX `init` state and one optax update; no JAX `train_step` is
compiled).
"""
import copy
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from boardlaw_tpu import storage as jstorage, train as jtrain
from boardlaw_tpu.models.networks import FCModel as JFCModel
from boardlaw_tpu.pavlov import runs as jruns, storage as jpstorage
from boardlaw_tpu_torch import storage as tstorage, train
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex
from boardlaw_tpu_torch.models import convert
from boardlaw_tpu_torch.models.networks import FCModel
from boardlaw_tpu_torch.pavlov import logs, runs, stats, storage
from boardlaw_tpu_torch.pavlov.tests import mock_dir

torch.set_num_threads(2)

TINY = dict(boardsize=3, width=4, depth=1, n_envs=8, nodes=8, mix_steps=16, buffer_len=4,
            storer="time", device="cpu")


def test_tiny_run_and_resume():
    with mock_dir():
        run = train.run(max_steps=2, **TINY)
        sd = storage.load_latest(run)
        assert sd["agent"]["step"] == 2
        assert "params" in sd["agent"]
        assert stats.resampled(run, "count.samples", "1h").dropna().iloc[-1] == 16
        assert stats.rows(run, "count.samples")["total"].sum() == 16
        for channel in ("loss.total", "grad.norm", "wins.seat-0", "sample-rate.actor",
                        "step-rate.learner", "n-trajs", "noise-scale", "time.step",
                        "time.setup.init", "time.setup.warmup", "time.save.latest"):
            assert channel in stats.channels(run), channel
        assert "step 2" in logs.tail(run)
        assert storage.load_raw(run, "model")["cfg"]["width"] == 4
        assert runs.info(run)["params"]["n_envs"] == 8

        # resume continues the same run and step counter
        train.run(max_steps=4, resume=run, **TINY)
        sd2 = storage.load_latest(run)
        assert sd2["agent"]["step"] == 4
        # sample/FLOP accounting continues rather than restarting at zero:
        # 2 steps x 8 envs before resume, +2 after = 32 total samples
        assert sd2["n_samples"] == 32
        assert sd2["n_flops"] > sd["n_flops"] > 0
        assert runs.list_runs() == [run]


def test_storer_seed_advances_savepoints():
    with mock_dir():
        run = runs.new_run(description="seed-test")
        storer = tstorage.FlopsStorer(run, boardsize=3, flops_per=1.0)
        mid = storer.savepoints[5]
        storer.seed(n_flops=mid, n_samples=123.0, runtime=7.0)
        assert storer.n_samples == 123.0
        # savepoints at or below the restored FLOP count are already taken
        assert storer.next_point == 6
        timed = tstorage.TimeStorer(run, boardsize=3, flops_per=1.0)
        timed.seed(n_flops=0.0, n_samples=0.0, runtime=timed.savepoints[3])
        assert timed.next_point == 4


def test_flops_per_sample():
    params = {"w": np.zeros((4, 8)), "b": np.zeros(8), "alpha": np.zeros(())}
    # 2D: 32 MACs, 1D: 8 adds, 0D scalars ignored -> 40 per eval, x nodes
    assert tstorage.flops_per_sample(params, 64) == 64 * 40
    assert tstorage.flops_per_sample({k: torch.tensor(v) for k, v in params.items()}, 64) == 2560


def test_flops_per_sample_equals_jax_on_converted_params():
    world = thex.Hex.initial(1, 5, device="cpu")
    jmodel = JFCModel(world.obs_space, world.action_space, width=16, depth=3)
    jworld = jtrain.hex.Hex.initial(1, 5)
    params = jmodel.init(jax.random.PRNGKey(0), jworld.obs, jworld.valid, jworld.seats)
    model = FCModel(world.obs_space, world.action_space, width=16, depth=3, device="cpu")
    model.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    want = jstorage.flops_per_sample(params, 64)
    assert want > 0
    assert tstorage.flops_per_sample(model, 64) == want
    assert tstorage.flops_per_sample(model.state_dict(), 64) == want


def _adam_state(optimizer):
    return [(s["step"], s["exp_avg"], s["exp_avg_sq"]) for s in optimizer.state.values()]


def test_checkpoint_round_trip():
    cfg = train.make_config(3, 4, 1, nodes=8, n_envs=8, buffer_len=4, mix_steps=16)
    _, _, init, warmup, train_step = train.make_train(cfg, device="cpu")
    draws = Draws(0, "cpu")
    state = warmup(init(draws), draws)
    for _ in range(2):
        state, _ = train_step(state, draws)
    with mock_dir():
        run = runs.new_run()
        storage.save_latest(run, train.state_dict(state, cfg))
        sd = storage.load_latest(run)
    assert sd["step"] == 2 and sd["kwargs"] == {"n_nodes": 8.0, "c_puct": 1 / 16}
    fresh = init(Draws(1, "cpu"))
    train.load_state_dict(fresh, sd)
    assert fresh.step == 2
    for (na, a), (nb, b) in zip(state.model.state_dict().items(),
                                fresh.model.state_dict().items()):
        assert na == nb and torch.equal(a, b), na
    for a, b in zip(_adam_state(state.optimizer), _adam_state(fresh.optimizer)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the loaded optimizer steps the loaded model: one more step on each
    # side takes the same Adam update
    fresh.worlds, fresh.buffer, fresh.ptr = copy.deepcopy((state.worlds, state.buffer, state.ptr))
    s1, _ = train_step(state, Draws(2, "cpu"))
    s2, _ = train_step(fresh, Draws(2, "cpu"))
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(a, b)


def _jax_payload(jcfg):
    """A JAX `init` state after one optax adam update with random
    gradients, as the JAX package's storer payload."""
    _, opt, init, _, _ = jtrain.make_train(jcfg)
    state = init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), state.params)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    state = state.replace(params=optax.apply_updates(state.params, updates),
                          opt_state=opt_state, step=jnp.asarray(5, jnp.int32))
    return state, {"agent": jtrain.state_dict(state, jcfg), "n_flops": 1e6,
                   "n_samples": 40.0, "runtime": 3.0}


def test_resumes_a_checkpoint_the_jax_package_wrote():
    jcfg = jtrain.TrainConfig(boardsize=3, width=4, depth=1, n_envs=8, n_nodes=8,
                              buffer_len=4, mix_steps=16)
    jstate, payload = _jax_payload(jcfg)
    with mock_dir():
        run = jruns.new_run(description="written by the JAX package", boardsize=3)
        jpstorage.save_latest(run, payload)

        # the port loads it: params and Adam state equal the converted ones
        read = storage.load_latest(run)
        assert read["n_samples"] == 40.0 and int(read["agent"]["step"]) == 5
        cfg = train.make_config(3, 4, 1, nodes=8, n_envs=8, buffer_len=4, mix_steps=16)
        _, _, init, _, _ = train.make_train(cfg, device="cpu")
        state = train.load_state_dict(init(Draws(0, "cpu")), read["agent"])
        assert state.step == 5
        want = convert.from_flax(jax.tree.map(np.asarray, jstate.params))
        for name, p in state.model.state_dict().items():
            assert torch.equal(p, want[name]), name
        adam = jstate.opt_state[0]
        mu, nu = convert.from_flax(adam.mu), convert.from_flax(adam.nu)
        for name, p in state.model.named_parameters():
            s = state.optimizer.state[p]
            assert float(s["step"]) == float(adam.count) == 1.0
            assert torch.equal(s["exp_avg"], mu[name].reshape(p.shape)), name
            assert torch.equal(s["exp_avg_sq"], nu[name].reshape(p.shape)), name
            assert s["exp_avg"].abs().sum() > 0

        # and `run` resumes the JAX run in place: the step counter and the
        # sample accounting go on
        train.run(max_steps=7, resume=run, **TINY)
        sd = storage.load_latest(run)
        assert sd["agent"]["step"] == 7
        assert sd["n_samples"] == 40.0 + 2 * 8
        assert sd["n_flops"] > 1e6
        assert runs.list_runs() == [run]
        assert "count.samples" in stats.channels(run)


def test_entry_points_refuse_what_the_port_lacks(monkeypatch):
    with mock_dir():
        with pytest.raises(ValueError, match="n_envs=8 does not split over n_devices=3"):
            train.run(n_devices=3, **TINY)
        cards = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"{cards} visible"):
            train.run(n_devices=max(cards + 1, 2), **{k: v for k, v in TINY.items() if k != "device"})
        if not torch.cuda.is_available():  # the card by default, never a quiet CPU run
            with pytest.raises(RuntimeError):
                train.run(**{k: v for k, v in TINY.items() if k != "device"})
        assert runs.list_runs() == []
    # run_best passes BEST's hyperparameters on
    calls = []
    monkeypatch.setattr(train, "run", lambda *a, **kw: calls.append((a, kw)) or "name")
    assert train.run_best(9, max_steps=1) == "name"
    assert calls == [((9, 512, 4), {"nodes": 64, "c_puct": 1 / 16, "max_steps": 1})]


def test_run_with_live_arena(monkeypatch):
    # `arena=True` spawns the live arena beside the run: the child loads the
    # run's latest checkpoint, plays the ladder, writes the `arena-games`
    # ledger and the `elo-arena` channel, and is terminated when the run
    # ends. The last step waits (up to 240 s) for the child's first round.
    from boardlaw_tpu_torch.arena import live

    children = []

    def spawn(run_name, ladder, device):
        children.append(live_run(run_name, interval=0.5, ladder=ladder, device=device))
        return children[-1]

    live_run = live.run
    monkeypatch.setattr(live, "run", spawn)
    step = train.train_step

    def waiting_step(cfg, state, draws):
        out = step(cfg, state, draws)
        if state.step == 3:
            run = runs.list_runs()[-1]
            deadline = time.monotonic() + 240
            while "elo-arena" not in stats.channels(run) and time.monotonic() < deadline:
                assert children[0].is_alive()
                time.sleep(0.2)
        return out

    monkeypatch.setattr(train, "train_step", waiting_step)
    with mock_dir():
        run = train.run(max_steps=3, arena=True, **TINY)
        assert len(children) == 1 and not children[0].is_alive()  # terminated and reaped
        assert "elo-arena" in stats.channels(run)
        trials = live.ledger_trials(run)
        assert set(trials.black_agent) | set(trials.white_agent) == {"latest", "rollout-1"}
        assert (trials.black_wins + trials.white_wins).sum() % 32 == 0
        assert storage.load_latest(run)["agent"]["step"] == 3
