"""The one seam through which the port draws random numbers.

JAX's threefry streams cannot be reproduced with a `torch.Generator`, so
every draw of the slice goes through a `Draws` object named by what it is
for. The default implementation uses an explicit `torch.Generator`; the
parity tests subclass it and return the arrays that the JAX package's key
tree produces, which makes the port comparable draw for draw.

The draws of a train step:

* `dirichlet(shape, rounds)`: the normals and uniforms of the fixed-round
  Marsaglia-Tsang gamma sampler, plus the boost uniforms used when the
  Dirichlet concentration is below 1 (`search._log_gamma_fixed`).
* `pass_rands(p, shape)`: the per-node uniforms of grow pass `p`, (K,B,R).
* `sim_rands(i, shape)`: the per-node uniforms of K=1 sim `i`, (B,T).
* `gumbel(shape)`: Gumbel noise for a categorical draw; `argmax(logits +
  gumbel)` is the draw (the actor's action, and each step of `mix`).
* `slots(B, T)`: the learner's timestep per env, uniform in [0, T), (B,)
  int64.
* `split()`: the stream of a sub-computation (a Monte Carlo rollout of
  `envs.validation.MonteCarloAgent`, an agent's move in an arena game),
  which JAX draws from a split key; here the same generator, drawn on in
  order.
* `integer(high)`: an integer in [0, high), the seed of a host-side numpy
  generator (the GTP agents' random blend, `mohex.MoHexAgent`).

`shard(rank, world)` is the view a data-parallel rank draws through
(`ShardedDraws`): every seam draws the global shape from the same stream
and keeps this rank's block of the env axis, so the ranks of a sharded run
consume, together, what the single-process run consumes, bit for bit (JAX's
partitionable threefry gives its sharded program the same). Each rank pays
for generating the whole batch's draws.
"""
from __future__ import annotations

import torch

from .utils import resolve_device


class Draws:
    def __init__(self, seed=0, device=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def uniform(self, shape, minval=0.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u.clamp_min(minval) if minval > 0 else u

    def normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def dirichlet(self, shape, rounds):
        """-> (normals (rounds,*shape), uniforms (rounds,*shape), boost uniforms shape)."""
        shape = tuple(shape)
        return (self.normal((rounds,) + shape),
                self.uniform((rounds,) + shape, minval=1e-20),
                self.uniform(shape, minval=1e-20))

    def pass_rands(self, p, shape):
        return self.uniform(tuple(shape))

    def sim_rands(self, i, shape):
        return self.uniform(tuple(shape))

    def slots(self, B, T):
        return torch.randint(0, T, (B,), generator=self.generator, device=self.device)

    def gumbel(self, shape):
        u = self.uniform(tuple(shape), minval=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def split(self):
        return self

    def integer(self, high):
        return int(torch.randint(0, high, (), generator=self.generator, device=self.device))

    def shard(self, rank, world):
        """This rank's view of the draws when the env axis is split into
        `world` contiguous blocks."""
        return ShardedDraws(self, rank, world)


class ShardedDraws(Draws):
    """Rank `rank`'s block of the env axis of `base`'s draws. Each seam is
    called with this rank's shape; it draws the shape of all `world` blocks
    from `base` and returns block `rank`, a contiguous copy. The env axis:
    axis 1 of the Dirichlet normals and uniforms (rounds, B, ...) and axis 0
    of its boost uniforms; axis 1 of `pass_rands` (K, B, R); axis 0 of
    `sim_rands` (B, T), `gumbel` and `slots`. `integer` is the same on
    every rank."""

    def __init__(self, base, rank, world):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.base, self.rank, self.world = base, rank, world
        self.device = base.device

    def _block(self, x, axis):
        n = x.shape[axis] // self.world
        return x.narrow(axis, self.rank * n, n).contiguous()

    def _global(self, shape, axis):
        shape = tuple(shape)
        return shape[:axis] + (shape[axis] * self.world,) + shape[axis + 1:]

    def uniform(self, shape, minval=0.0):
        raise TypeError("a sharded view draws only through its named seams")

    normal = uniform

    def dirichlet(self, shape, rounds):
        n, u, b = self.base.dirichlet(self._global(shape, 0), rounds)
        return self._block(n, 1), self._block(u, 1), self._block(b, 0)

    def pass_rands(self, p, shape):
        return self._block(self.base.pass_rands(p, self._global(shape, 1)), 1)

    def sim_rands(self, i, shape):
        return self._block(self.base.sim_rands(i, self._global(shape, 0)), 0)

    def slots(self, B, T):
        return self._block(self.base.slots(B * self.world, T), 0)

    def gumbel(self, shape):
        return self._block(self.base.gumbel(self._global(shape, 0)), 0)

    def split(self):
        return ShardedDraws(self.base.split(), self.rank, self.world)

    def integer(self, high):
        return self.base.integer(high)

    def shard(self, rank, world):
        raise TypeError("the draws are sharded already")
