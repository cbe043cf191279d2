"""Module-level functions that the spawned ranks and pool workers of
tests/test_torch_parallel.py and tests/test_torch_utils.py run. It imports
no JAX, so neither do they: the JAX side of a comparison is computed in
the test's own process and reaches the ranks as numpy."""
import io
import os
from types import SimpleNamespace

import torch

from boardlaw_tpu_torch import train
from boardlaw_tpu_torch.arena import live
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.mcts import search
from boardlaw_tpu_torch.parallel import shard_train_state


class Replay(Draws):
    """Draws that replay a recording: a list of (seam, shape, outputs) in
    the order the seams were called, outputs as numpy. Each call must name
    the recorded seam and shape."""

    def __init__(self, recording):
        self.device = torch.device("cpu")
        self.recording = list(recording)

    def _next(self, seam, shape):
        want, want_shape, out = self.recording.pop(0)
        assert (want, tuple(want_shape)) == (seam, tuple(shape)), (seam, shape, want, want_shape)
        return out

    def dirichlet(self, shape, rounds):
        return tuple(torch.tensor(x) for x in self._next("dirichlet", (rounds,) + tuple(shape)))

    def pass_rands(self, p, shape):
        return torch.tensor(self._next(f"pass_rands.{p}", shape))

    def sim_rands(self, i, shape):
        return torch.tensor(self._next(f"sim_rands.{i}", shape))

    def gumbel(self, shape):
        return torch.tensor(self._next("gumbel", shape))

    def slots(self, B, T):
        return torch.tensor(self._next("slots", (B, T)))


def _np(x):
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()


def q_bounds_rank(mesh, w, n):
    """`search._q_bounds` on this rank's block of a tree's (B,T,S) w and
    (B,T) n."""
    blk = mesh.block(w.shape[0])
    tree = SimpleNamespace(w=torch.tensor(w[blk]), n=torch.tensor(n[blk]), mesh=mesh)
    return search._q_bounds(tree).numpy()


def step_rank(mesh, cfg, state_bytes, recording):
    """One `train_step` of this rank's part of a whole `TrainState`
    (torch.save bytes), replaying the whole batch's recorded draws through
    the sharded view. Returns the rank's new worlds and pushed record, the
    aux, the reduced gradients and the new parameters, as numpy."""
    state = torch.load(io.BytesIO(state_bytes), weights_only=False)
    state = shard_train_state(state, mesh)
    slot = state.ptr
    state, aux = train.train_step(cfg, state, Replay(recording).shard(mesh.rank, mesh.size))
    record = {k: _np(x[slot]) for k, x in state.buffer.items() if k != "worlds"}
    record.update(board=_np(state.buffer["worlds"].board[slot]),
                  seats=_np(state.buffer["worlds"].seats[slot]))
    return {
        "ptr": state.ptr, "step": state.step,
        "worlds": {"board": _np(state.worlds.board), "seats": _np(state.worlds.seats)},
        "record": record,
        "aux": {k: float(v) for k, v in aux.items()},
        "grads": {k: _np(p.grad) for k, p in state.model.named_parameters()},
        "params": {k: _np(p) for k, p in state.model.named_parameters()},
    }


def slice_rank(mesh, q_args, steps):
    """Every payload of the whole-slice test in one world: the q-bounds,
    then each (cfg, state bytes, recording) step."""
    return {"q_bounds": q_bounds_rank(mesh, *q_args),
            "steps": [step_rank(mesh, *step) for step in steps]}


def random_loader(spec, device=None):
    """A league loader: every spec plays uniformly at random."""
    return live._random_agent()


def square(x):
    return x * x


def visible_cards(_):
    """The CUDA_VISIBLE_DEVICES a pool worker runs with."""
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def tower_steps_rank(mesh, cfg, steps):
    """`steps` train steps of this rank's block of `cfg` (the sharded view
    of `cfg.seed`'s draws) after init and warmup. Returns the rank's
    parameters and buffers, as numpy."""
    _, _, init, warmup, step = train.make_train(cfg, mesh=mesh)
    draws = Draws(cfg.seed, mesh.device).shard(mesh.rank, mesh.size)
    state = warmup(init(draws), draws)
    for _ in range(steps):
        state, _ = step(state, draws)
    return {"params": {k: _np(p) for k, p in state.model.named_parameters()},
            "buffers": {k: _np(b) for k, b in state.model.named_buffers()}}
