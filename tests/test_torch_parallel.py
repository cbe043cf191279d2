"""The port's data parallelism (`parallel/`, `Draws.shard`, `train.run(
n_devices=)`) against the JAX package's, on the CPU: ranks are spawned
processes joined over gloo, each with a free port, a bounded init
(`initialize`'s timeout) and a deadline on the whole world
(`distributed.launch`'s timeout).

* The sharded draws of every seam, the ranks' blocks concatenated, equal
  the unsharded draws bit for bit.
* `search._q_bounds` over 2 ranks' blocks of a tree equals JAX
  `search._q_bounds` over the whole tree bit for bit (a min and a max).
* The slice as a whole: JAX `make_train` at boardsize 3 (K=1,
  tests/test_torch_train.py's config) and at K=8 grow passes, the state
  placed by `shard_train_state(..., make_mesh(2))` on the conftest's
  virtual CPU devices, one sharded `train_step`; the port's 2 ranks from
  `convert.train_state_from_jax` take one `train_step` on the same draws
  (JAX's, recorded as numpy here and sliced per rank), compared by
  tests/test_torch_train.py's rules: integer records equal; float records
  to atol 1e-5 (bf16 logits to one bf16 step); aux to rtol 1e-4 / atol
  1e-6; gradients to rtol 1e-4 / atol 1e-6; parameters to atol 1e-6 where
  |g| > 1e-6, else to atol lr. The ranks' aux, gradients and parameters
  are bit-equal, and the 2-rank step equals the port's single-process
  step: records and worlds exactly, aux to rtol 1e-5 / atol 1e-7,
  gradients and parameters to atol 1e-6 (the all-reduce sums in another
  order).
* AlphaGo Zero's tower (`net="az"`, batch norm) on 2 ranks: after 2
  steps both ranks hold equal weights and equal buffers, the running
  statistics averaged over the ranks after each learner step; after 1 the
  intake's running mean, whose input no batch norm has normalised by a
  rank's block, is the single process's (the whole batch's) to atol 1e-6.
* `train.run(n_devices=2, device="cpu")` and its resume; `initialize` from
  the FLEET_* variables with `worker_main` in two processes (the
  assertions of tests/test_distributed.py); `neural.evaluate_parallel`
  over a 2-worker CPU pool (tests/test_arena.py::test_league_farm_out).
"""
import copy
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu import parallel as jparallel, train as jtrain
from boardlaw_tpu.mcts import search as jsearch
from boardlaw_tpu_torch import parallel, train
from boardlaw_tpu_torch.arena import neural
from boardlaw_tpu_torch.draws import Draws, ShardedDraws
from boardlaw_tpu_torch.models import convert
from boardlaw_tpu_torch.parallel import distributed
from boardlaw_tpu_torch.pavlov import logs, runs, stats, storage
from boardlaw_tpu_torch.pavlov.tests import mock_dir
from test_torch_train import JaxTrainDraws
import torch_workers

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240  # s, a whole spawned world

# --------------------------------------------------------------------------
# Sharded draws
# --------------------------------------------------------------------------

# seam -> (call, env axis of each output)
SEAMS = {
    "dirichlet": (lambda d, B: d.dirichlet((B, 9), 4), (1, 1, 0)),
    "pass_rands": (lambda d, B: d.pass_rands(3, (8, B, 17)), (1,)),
    "sim_rands": (lambda d, B: d.sim_rands(2, (B, 8)), (0,)),
    "gumbel": (lambda d, B: d.gumbel((B, 25)), (0,)),
    "slots": (lambda d, B: d.slots(B, 64), (0,)),
}


@pytest.mark.parametrize("seam", sorted(SEAMS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_draws_concatenate_to_the_unsharded(seam, world):
    call, axes = SEAMS[seam]
    B = 12
    whole = Draws(7, "cpu")
    parts = [Draws(7, "cpu").shard(r, world) for r in range(world)]
    for _ in range(2):  # the stream goes on alike after the first call
        want = call(whole, B)
        got = [call(p, B // world) for p in parts]
        want = want if isinstance(want, tuple) else (want,)
        got = [g if isinstance(g, tuple) else (g,) for g in got]
        for i, axis in enumerate(axes):
            blocks = [g[i] for g in got]
            assert all(b.is_contiguous() for b in blocks)
            assert torch.equal(torch.cat(blocks, axis), want[i]), (seam, i)


def test_sharded_draws_refuse_what_has_no_env_axis():
    d = Draws(0, "cpu").shard(1, 2)
    assert isinstance(d, ShardedDraws) and (d.rank, d.world) == (1, 2)
    assert isinstance(d.split(), ShardedDraws)
    assert d.integer(100) == Draws(0, "cpu").integer(100)
    for call in (lambda: d.uniform((4,)), lambda: d.normal((4,)), lambda: d.shard(0, 2)):
        with pytest.raises(TypeError):
            call()
    with pytest.raises(ValueError):
        Draws(0, "cpu").shard(2, 2)


def test_env_sharding_and_mesh_checks():
    x = torch.arange(24).reshape(2, 6, 2)
    blocks = [parallel.env_sharding(parallel.mesh.Mesh(None, r, 3, torch.device("cpu")), 1)(x)
              for r in range(3)]
    assert torch.equal(torch.cat(blocks, 1), x) and all(b.is_contiguous() for b in blocks)
    assert blocks[0].untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="do not split"):
        parallel.env_sharding(parallel.mesh.Mesh(None, 0, 4, torch.device("cpu")), 1)(x)
    with pytest.raises(RuntimeError, match="initialize"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="FLEET_COORD"):
        distributed.initialize(device="cpu")
    # a mesh's state steps only through the sharded view of the draws
    mesh = parallel.mesh.Mesh(None, 0, 1, torch.device("cpu"))
    cfg = train.make_config(3, 4, 1, nodes=4, n_envs=4, buffer_len=2, mix_steps=2)
    _, _, init, _, _ = train.make_train(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="shard"):
        init(Draws(0, "cpu"))
    assert init(Draws(0, "cpu").shard(0, 1)).mesh is mesh
    with pytest.raises(ValueError, match="split"):
        train.make_train(train.make_config(3, 4, 1, n_envs=5),
                         mesh=parallel.mesh.Mesh(None, 0, 2, torch.device("cpu")))


# --------------------------------------------------------------------------
# The slice as a whole: JAX's sharded step against the port's 2 ranks
# --------------------------------------------------------------------------

class Recorder(Draws):
    """Passes `base`'s draws on and records them as `torch_workers.Replay`
    plays them back."""

    def __init__(self, base):
        self.device = base.device
        self.base = base
        self.recording = []

    def _keep(self, seam, shape, out):
        self.recording.append((seam, tuple(shape), tuple(x.numpy() for x in out)
                               if isinstance(out, tuple) else out.numpy()))
        return out

    def dirichlet(self, shape, rounds):
        return self._keep("dirichlet", (rounds,) + tuple(shape), self.base.dirichlet(shape, rounds))

    def pass_rands(self, p, shape):
        return self._keep(f"pass_rands.{p}", shape, self.base.pass_rands(p, shape))

    def sim_rands(self, i, shape):
        return self._keep(f"sim_rands.{i}", shape, self.base.sim_rands(i, shape))

    def gumbel(self, shape):
        return self._keep("gumbel", shape, self.base.gumbel(shape))

    def slots(self, B, T):
        return self._keep("slots", (B, T), self.base.slots(B, T))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


KW = dict(n_envs=8, buffer_len=4, mix_steps=16)
CASES = {
    # tests/test_torch_train.py's K=1 config
    "k1": (jtrain.TrainConfig(boardsize=3, width=16, depth=2, n_nodes=8, **KW),
           train.make_config(3, 16, 2, nodes=8, **KW), 7, 5),
    # K=8 grow passes, in the kernels' sampling order
    "k8": (jtrain.TrainConfig(boardsize=3, width=16, depth=2, n_nodes=17, leaves_per_pass=8,
                              grow_passes=True, use_pallas=False, pallas_walk=False,
                              sample_cum="shift", **KW),
           train.make_config(3, 16, 2, nodes=17, leaves_per_pass=8, grow_passes=True, **KW),
           16, 6),
}


def _jax_sharded_step(jcfg, seed):
    """JAX's state after init and warmup (non-zero ReZero gates), and its
    sharded train step over a 2-device mesh."""
    mesh = jparallel.make_mesh(2)
    _, _, init, warmup, train_step = jtrain.make_train(jcfg, mesh=mesh)
    jstate = warmup(init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    jstate = jstate.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.normal(0, 0.5), x.dtype)
        if path[-1].key == "alpha" else x, jstate.params))
    before = _np(jstate)
    sharded = jparallel.shard_train_state(jstate, mesh)
    assert sharded.worlds.board.sharding.spec[0] == "dp"
    jnew, jaux = train_step(sharded)
    return before, _np(jnew), _np(jaux)


@pytest.fixture(scope="module")
def world_of_two():
    """Every JAX reference, then one spawned world of 2 ranks that runs the
    q-bounds and both cases' steps."""
    # a K=8 tree's node statistics mid-search: uneven q, so the bounds move
    rng = np.random.default_rng(3)
    w = rng.normal(0, 2, (8, 17, 2)).astype(np.float32)
    n = rng.integers(0, 9, (8, 17)).astype(np.int32)
    w[5, 3] = [40.0, -40.0]  # the extremes lie in rank 1's block
    n[5, 3] = 1
    jq = jsearch._q_bounds(SimpleNamespace(w=jnp.asarray(w), n=jnp.asarray(n)))
    refs, steps = {}, []
    for name, (jcfg, tcfg, n_sims, seed) in CASES.items():
        before, jnew, jaux = _jax_sharded_step(jcfg, seed)
        tstate = convert.train_state_from_jax(before, tcfg, device="cpu")
        rec = Recorder(JaxTrainDraws(jnp.asarray(before.key), n_sims))
        single = copy.deepcopy(tstate)
        single, saux = train.train_step(tcfg, single, rec)
        buf = io.BytesIO()
        torch.save(tstate, buf)
        steps.append((tcfg, buf.getvalue(), rec.recording))
        refs[name] = dict(before=before, jnew=jnew, jaux=jaux, single=single, saux=saux,
                          slot=int(before.ptr), lr=tcfg.lr)
    ranks = distributed.launch(torch_workers.slice_rank, 2, device="cpu",
                               args=((w, n), steps), timeout=DEADLINE)
    return {"jq": np.array([float(jq[0]), float(jq[1])], np.float32), "ranks": ranks,
            "refs": refs}


def _ranks_step(world, name):
    return [r["steps"][list(CASES).index(name)] for r in world["ranks"]]


def test_q_bounds_over_two_ranks_match_jax(world_of_two):
    for r in world_of_two["ranks"]:
        np.testing.assert_array_equal(r["q_bounds"], world_of_two["jq"])
    assert world_of_two["jq"][0] < -30 and world_of_two["jq"][1] > 30


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_records_match_jax(world_of_two, name):
    ref = world_of_two["refs"][name]
    outs = _ranks_step(world_of_two, name)
    jnew, slot = ref["jnew"], ref["slot"]
    assert all((o["ptr"], o["step"]) == (int(jnew.ptr), int(jnew.step)) for o in outs)
    for k in ("board", "seats"):
        got = np.concatenate([o["worlds"][k] for o in outs])
        np.testing.assert_array_equal(got, getattr(jnew.worlds, k), err_msg=k)
        got = np.concatenate([o["record"][k] for o in outs])
        np.testing.assert_array_equal(got, getattr(jnew.buffer["worlds"], k)[slot], err_msg=k)
    rec = {k: np.concatenate([o["record"][k] for o in outs]) for k in outs[0]["record"]}
    for k in ("n_leaves", "terminal"):
        np.testing.assert_array_equal(rec[k], jnew.buffer[k][slot], err_msg=k)
    for k in ("v", "rewards"):
        np.testing.assert_allclose(rec[k], jnew.buffer[k][slot], atol=1e-5, err_msg=k)
    for k in ("logits", "prior"):
        j = np.asarray(jnew.buffer[k][slot], np.float32)
        np.testing.assert_array_equal(np.isneginf(rec[k]), np.isneginf(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(rec[k][fin], j[fin], rtol=2 ** -7, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_aux_match_jax(world_of_two, name):
    ref = world_of_two["refs"][name]
    outs = _ranks_step(world_of_two, name)
    assert outs[0]["aux"] == outs[1]["aux"]  # the whole batch's, on every rank
    jaux = ref["jaux"]
    assert set(outs[0]["aux"]) == set(jaux)
    for k in sorted(jaux):
        np.testing.assert_allclose(outs[0]["aux"][k], float(jaux[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_learner_matches_jax(world_of_two, name):
    ref = world_of_two["refs"][name]
    outs = _ranks_step(world_of_two, name)
    adam = ref["jnew"].opt_state[0]
    assert int(adam.count) == 1
    jgrads = {k: (v / 0.1).numpy() for k, v in convert.from_flax(adam.mu).items()}
    jparams = {k: v.numpy() for k, v in convert.from_flax(ref["jnew"].params).items()}
    for k, g in outs[0]["grads"].items():
        # every rank applied the same reduced bytes
        np.testing.assert_array_equal(outs[1]["grads"][k], g, err_msg=k)
        np.testing.assert_array_equal(outs[1]["params"][k], outs[0]["params"][k], err_msg=k)
        jg, want = jgrads[k].reshape(g.shape), jparams[k].reshape(g.shape)
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6, err_msg=k)
        p, big = outs[0]["params"][k], np.abs(jg) > 1e-6
        np.testing.assert_allclose(p[big], want[big], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(p[~big], want[~big], rtol=0, atol=ref["lr"], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_equals_single_process(world_of_two, name):
    ref = world_of_two["refs"][name]
    outs, single, slot = _ranks_step(world_of_two, name), ref["single"], ref["slot"]
    np.testing.assert_array_equal(np.concatenate([o["worlds"]["board"] for o in outs]),
                                  single.worlds.board.numpy())
    for k, x in single.buffer.items():
        if k != "worlds":
            np.testing.assert_array_equal(np.concatenate([o["record"][k] for o in outs]),
                                          x[slot].float().numpy() if x.dtype == torch.bfloat16
                                          else x[slot].numpy(), err_msg=k)
    for k, v in ref["saux"].items():
        np.testing.assert_allclose(outs[0]["aux"][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, p in single.model.named_parameters():
        np.testing.assert_allclose(outs[0]["grads"][k], p.grad.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs[0]["params"][k], p.detach().numpy(), rtol=0, atol=1e-6)


AZ = dict(nodes=8, n_envs=8, buffer_len=3, mix_steps=5, net="az")


@pytest.mark.parametrize("steps", [1, 2])
def test_tower_ranks_hold_equal_weights_and_buffers(steps):
    cfg = train.make_config(5, 8, 2, **AZ)
    ranks = distributed.launch(torch_workers.tower_steps_rank, 2, device="cpu",
                               args=(cfg, steps), timeout=DEADLINE)
    for kind in ("params", "buffers"):
        assert ranks[0][kind].keys() == ranks[1][kind].keys() and ranks[0][kind]
        for k, x in ranks[0][kind].items():
            np.testing.assert_array_equal(ranks[1][kind][k], x, err_msg=k)
    if steps == 1:
        # the intake's running mean moves by the whole batch's mean; the
        # deeper ones see activations each rank normalised by its own block
        _, _, init, warmup, step = train.make_train(cfg, device="cpu")
        draws = Draws(cfg.seed, "cpu")
        state, _ = step(warmup(init(draws), draws), draws)
        k = "intake.bn.running_mean"
        np.testing.assert_allclose(ranks[0]["buffers"][k], state.model.intake.bn.running_mean
                                   .numpy(), rtol=0, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# The entry points
# --------------------------------------------------------------------------

TINY = dict(boardsize=3, width=4, depth=1, n_envs=8, nodes=8, mix_steps=16, buffer_len=4,
            storer="time", device="cpu")


def test_run_on_two_ranks_and_resume():
    with mock_dir():
        run = train.run(max_steps=2, n_devices=2, **TINY)
        assert runs.list_runs() == [run]
        sd = storage.load_latest(run)
        assert sd["agent"]["step"] == 2 and sd["n_samples"] == 16
        # rank 0 alone writes: one row a step of the whole batch's samples
        rows = stats.rows(run, "count.samples")["total"]
        assert rows.tolist() == [8.0, 8.0]
        assert logs.tail(run).count("step 2") == 1
        for channel in ("loss.total", "grad.norm", "corr.terminal", "v.target.std",
                        "time.step", "time.setup.init"):
            assert channel in stats.channels(run), channel

        train.run(max_steps=4, resume=run, n_devices=2, **TINY)
        sd2 = storage.load_latest(run)
        assert sd2["agent"]["step"] == 4 and sd2["n_samples"] == 32
        assert stats.rows(run, "count.samples")["total"].sum() == 32
        assert runs.list_runs() == [run]


def test_fleet_workers_initialize_from_env(tmp_path):
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, FLEET_COORD=f"localhost:{port}", FLEET_NUM_PROCS="2",
                   FLEET_PROC_ID=str(rank), FLEET_DEVICE="cpu", PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "boardlaw_tpu_torch.parallel.distributed"], cwd=tmp_path,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=DEADLINE) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    results = [json.loads((tmp_path / "output" / f"result-{r}.json").read_text())
               for r in range(2)]
    assert {r["process"] for r in results} == {0, 1}
    assert all(r["n_processes"] == 2 and r["n_devices"] == 2 for r in results)
    # both ranks hold the whole batch's loss
    assert results[0]["loss"] == pytest.approx(results[1]["loss"], rel=1e-6)
    assert all(r["step"] == 1 for r in results)


def test_league_farm_out_on_cpu_workers():
    # tests/test_arena.py::test_league_farm_out on the port: 4 agents in
    # chunks of 2 over a 2-worker pool; every ordered pair plays n_envs_per
    specs = {name: None for name in "abcd"}
    trials = neural.evaluate_parallel(3, specs, loader=torch_workers.random_loader,
                                      n_envs_per=2, chunk_size=2, kind="device",
                                      max_workers=2, device="cpu")
    assert isinstance(trials, neural.Trials)
    pairs = [(b, w) for b, w, _, _ in trials.rows()]
    assert sorted(pairs) == sorted(neural.all_matchups(list("abcd")))
    assert ((trials.black_wins + trials.white_wins) == 2).all()
