"""The random numbers a run feeds the program, and the reference again.

The program draws every random number through one object with named seams
(`dirichlet`, `pass_rands`, `sim_rands`, `gumbel`, `slots`, ...). The
benchmark hands it a `KeyedDraws`: the n-th call of a run draws from a
generator seeded by a hash of (seed, n). A check that knows a call's
number replays the same numbers from a fresh `KeyedDraws(seed, device,
start=n)`, with no tape of what was drawn.
"""
from __future__ import annotations

import hashlib

import torch


class KeyedDraws:
    def __init__(self, seed, device, start=0):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = int(start)
        self.generator = torch.Generator(device=self.device)

    def _next(self):
        key = hashlib.blake2b(f"{self.seed}/{self.n}".encode(), digest_size=8).digest()
        self.generator.manual_seed(int.from_bytes(key, "little") >> 1)
        self.n += 1
        return self.generator

    def _uniform(self, g, shape, minval=0.0):
        u = torch.rand(tuple(shape), generator=g, device=self.device)
        return u.clamp_min(minval) if minval > 0 else u

    def uniform(self, shape, minval=0.0):
        return self._uniform(self._next(), shape, minval)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self._next(), device=self.device)

    def dirichlet(self, shape, rounds):
        """-> (normals (rounds,*shape), uniforms (rounds,*shape), boost
        uniforms shape), from one key."""
        g = self._next()
        shape = tuple(shape)
        return (torch.randn((rounds,) + shape, generator=g, device=self.device),
                self._uniform(g, (rounds,) + shape, 1e-20), self._uniform(g, shape, 1e-20))

    def pass_rands(self, p, shape):
        return self.uniform(shape)

    def sim_rands(self, i, shape):
        return self.uniform(shape)

    def slots(self, B, T):
        return torch.randint(0, T, (B,), generator=self._next(), device=self.device)

    def gumbel(self, shape):
        u = self.uniform(shape, minval=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def split(self):
        return self

    def integer(self, high):
        return int(torch.randint(0, high, (), generator=self._next(), device=self.device))

    def shard(self, rank, world):
        raise TypeError("the benchmark's cells run on one card")
