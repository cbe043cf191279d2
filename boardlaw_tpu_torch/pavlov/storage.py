"""Checkpoints: latest, numbered snapshots, named objects. Counterpart of
boardlaw_tpu/pavlov/storage.py, with the same file names and contract:

  storage.latest.pkl        overwritten in place, with a throttled variant
  storage.snapshot.{n}.pkl  numbered, append-only, registered with kwargs
  storage.named.{name}.pkl  an arbitrary pickled object (the model's config)

Every write is an atomic tmp+rename.

The port writes a state tree (nested dicts and lists of tensors and Python
scalars) with `torch.save`, its tensors copied to the host at the write and
only then, and reads it back with `torch.load(weights_only=True)`. The
loaders also read what the JAX package writes: flax's msgpack, in which an
ndarray is ext type 1 holding the msgpack triple (shape, dtype name,
C-order bytes) and a numpy scalar is ext type 3 of the same form. A small
decoder of that msgpack subset lives here (`msgpack_restore`), so no
msgpack package is needed; it decodes arrays into CPU tensors (bfloat16 as
torch bfloat16) and refuses flax's chunked form of arrays above 1 GiB
rather than misread it. A torch file is a zip archive, so its first bytes
("PK") tell the two formats apart. Named objects are pickled.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import tempfile
import time

import numpy as np
import torch

from . import files, runs

_LATEST_THROTTLE = {}


def _atomic_write(path, payload: bytes):
    path = str(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def to_host(tree):
    """A copy of a state tree with every tensor detached and copied to the
    host, compact (a view does not drag its whole storage along)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.cpu() if t.is_cuda else t.clone()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def state_bytes(tree):
    buf = io.BytesIO()
    torch.save(to_host(tree), buf)
    return buf.getvalue()


def state_from_bytes(payload):
    """A state tree from the port's torch format or the JAX package's flax
    msgpack."""
    if payload[:2] == b"PK":
        return torch.load(io.BytesIO(payload), weights_only=True)
    return msgpack_restore(payload)


# -- flax msgpack, read only ---------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray(data):
    """An ext-type array: the msgpack triple (shape, dtype name, bytes)."""
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # numpy has no bfloat16: read the words as torch's
        flat = torch.frombuffer(bytearray(buf), dtype=torch.int16).view(torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(name)).copy())
    return flat.reshape(tuple(shape))


class _Reader:
    """A msgpack decoder for the types flax writes: nil, bools, ints,
    floats, str, bin, arrays, maps and the ext types above."""

    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data).reshape(()).item()
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sizes:
            return self.take(self.unpack(sizes[b]))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str 8/16/32
        if b in sizes:
            return self.str(self.unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in sizes:
            return self.ext(self.unpack(sizes[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("a chunked flax array (above 1 GiB) is not supported")
        return out


def msgpack_restore(payload):
    """The tree that flax's `msgpack_serialize` wrote: dicts, lists, Python
    scalars, arrays as CPU tensors."""
    r = _Reader(payload)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return out


# -- latest -------------------------------------------------------------------

def save_latest(run, tree):
    run = runs.resolve(run)
    name = "storage.latest.pkl"
    if name not in runs.info(run).get("_files", {}):
        files.new_file(run, name)
    _atomic_write(files.path(run, name), state_bytes(tree))


def throttled_latest(run, tree, throttle=60):
    """Overwrite `latest` at most every `throttle` seconds."""
    key = (runs.resolve(run),)
    now = time.monotonic()
    if now - _LATEST_THROTTLE.get(key, -float("inf")) >= throttle:
        save_latest(run, tree)
        _LATEST_THROTTLE[key] = now
        return True
    return False


def load_latest(run):
    run = runs.resolve(run)
    with open(files.path(run, "storage.latest.pkl"), "rb") as f:
        return state_from_bytes(f.read())


def has_latest(run):
    return files.path(runs.resolve(run), "storage.latest.pkl").exists()


# -- numbered snapshots -------------------------------------------------------

def save_snapshot(run, tree, **kwargs):
    run = runs.resolve(run)
    p = files.new_file(run, "storage.snapshot.{n}.pkl", **kwargs)
    _atomic_write(p, state_bytes(tree))
    return p


def snapshots(run):
    """{index: path} of the saved snapshots."""
    run = runs.resolve(run)
    return {n: files.path(run, f) for n, f in files.seq(run, "storage.snapshot.{n}.pkl")}


def load_snapshot(run, n):
    with open(snapshots(run)[n], "rb") as f:
        return state_from_bytes(f.read())


def snapshot_info(run, n):
    return files.info(run, f"storage.snapshot.{n}.pkl")


# -- named objects -------------------------------------------------------------

def save_raw(run, name, obj):
    """Pickle an object (e.g. the model's config), so a reader need not
    rebuild it from code. The JAX package pickles with cloudpickle, which
    also takes lambdas; plain data pickles alike either way."""
    run = runs.resolve(run)
    fname = f"storage.named.{name}.pkl"
    if fname not in runs.info(run).get("_files", {}):
        files.new_file(run, fname)
    _atomic_write(files.path(run, fname), pickle.dumps(obj))


def load_raw(run, name):
    with open(files.path(runs.resolve(run), f"storage.named.{name}.pkl"), "rb") as f:
        return pickle.load(f)
