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
