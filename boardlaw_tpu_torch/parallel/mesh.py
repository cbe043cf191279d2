"""Data-parallel placement of the training state over the ranks of a
process group. Counterpart of boardlaw_tpu/parallel/mesh.py.

The JAX package shards the env axis of one program over a device mesh and
lets GSPMD insert the collectives. Here each rank is a process with one
device and holds only its own contiguous block of the env axis; a `Mesh`
is that process group with this rank's place in it, and the collectives
are explicit: the gradient's all-reduce and the step's aux
(`train.train_step`), the search's q-bounds (`mcts.search._q_bounds`), and
the broadcast from rank 0 that replicates the parameters and the Adam
state. Only `all_reduce` and `broadcast` are used, the two collectives
gloo offers on CUDA tensors.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..mcts.search import _map_world

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a data-parallel world: the process group
    (None for a world of one), `rank`, `size` and the rank's `device`."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "dp"

    def block(self, n):
        """This rank's contiguous slice of an env axis of length `n`."""
        if n % self.size:
            raise ValueError(f"{n} envs do not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, x, op="sum"):
        """Reduce `x` over the ranks in place ('sum' or 'max'); returns it."""
        if self.size > 1:
            dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def broadcast(self, x, src=0):
        """Overwrite `x` with rank `src`'s in place; returns it. A tensor on
        another device than the rank's travels through a copy on it."""
        if self.size == 1:
            return x
        y = x if x.device == self.device else x.to(self.device)
        dist.broadcast(y, src, group=self.group)
        if y is not x:
            x.copy_(y)
        return x


def make_mesh(n_devices=None, axis="dp"):
    """The mesh of this process's data-parallel world, one rank a device
    (`distributed.initialize` first). `n_devices`, where given, must be the
    world's size."""
    from . import distributed

    device = distributed.local_device()
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {size} ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=device,
                axis=axis)


def env_sharding(mesh, batch_axis=0):
    """A function that slices a tensor's env axis (`batch_axis`) to this
    rank's contiguous block: a contiguous copy on the rank's device. An env
    axis that does not split evenly raises ValueError."""

    def of(x):
        if x.ndim <= batch_axis:
            return x.to(mesh.device)
        blk = mesh.block(x.shape[batch_axis])
        return x.narrow(batch_axis, blk.start, blk.stop - blk.start).to(
            mesh.device, memory_format=torch.contiguous_format, copy=True)

    return of


def replicated(mesh):
    """A function that makes a tensor rank 0's on every rank, in place."""
    return mesh.broadcast


def shard_train_state(state, mesh):
    """This rank's part of a whole `train.TrainState` (the same on every
    rank): the worlds' env axis 0 and the buffer's env axis 1 (its leaves
    are (T, B, ...)) sliced to this rank's block, and a copy of the model
    (its weights and buffers) and of its Adam state on the rank's device,
    broadcast from rank 0. The returned state carries the mesh, which
    `train_step` reads."""
    from ..train import TrainState

    world_shard, buffer_shard = env_sharding(mesh, 0), env_sharding(mesh, 1)
    buffer = {k: buffer_shard(x) for k, x in state.buffer.items() if k != "worlds"}
    buffer["worlds"] = _map_world(state.buffer["worlds"], buffer_shard)
    model = copy.deepcopy(state.model).to(mesh.device)
    optimizer = type(state.optimizer)(model.parameters(), **state.optimizer.defaults)
    optimizer.load_state_dict(state.optimizer.state_dict())
    place = replicated(mesh)
    for p in model.parameters():
        place(p.data)
        for s in optimizer.state.get(p, {}).values():
            if torch.is_tensor(s):
                place(s)
    for b in model.buffers():
        place(b)
    counters = place(torch.tensor([state.ptr, state.step], dtype=torch.int64))
    return TrainState(worlds=_map_world(state.worlds, world_shard), buffer=buffer,
                      ptr=int(counters[0]), model=model, optimizer=optimizer,
                      step=int(counters[1]), mesh=mesh)
