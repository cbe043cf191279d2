"""The search's two hand-written CUDA kernels, their wrappers, their plain
PyTorch twins and their launch counts.

* `walk` (csrc/walk.cu) replaces the Pallas `walk` of
  boardlaw_tpu/mcts/pallas_kernels.py: the root->leaf pointer chase.
  Twin: `walk_ref`, which is `search._walk` after the halting test.
* `node_actions_multi` (csrc/node_actions_multi.cu) replaces the Pallas
  `node_actions_multi`: every node's regularized-policy solve, the log-shift
  prefix sum and K inverse-CDF draws with their child lookups.
  Twin: `node_actions_multi_ref`, which is `search.node_probs` +
  `search._sample_children_multi(cum_mode='shift')`.

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches the
kernel or raises, with no fallback. Each launch adds one to the wrapper's
`launches` attribute and nowhere else.

The kernels are compiled at first use with nvcc for sm_90a, one object per
source in parallel, linked into one shared library with a plain C interface
under `boardlaw_tpu_torch/_build/` (named by a hash of the sources), and
loaded with ctypes. They launch on the current stream and allocate nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import search

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = ("walk.cu", "node_actions_multi.cu")
_BUILD_DIR = _PKG / "_build"
# -fmad=false: no fused multiply-adds, so each element's float arithmetic
# rounds like the plain twin's separate PyTorch ops
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build(verbose=False):
    """Compile the kernels (if the sources changed) and load the library.
    Returns the ctypes handle. Safe to call repeatedly."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = [_PKG / "csrc" / s for s in _SOURCES]
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = _BUILD_DIR / f"libboardlaw_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
            extra = ["-Xptxas", "-v"] if verbose else []
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)
            ]
            outs = [p.communicate()[0] for p in procs]
            for s, p, out in zip(srcs, procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
                if verbose and out:
                    print(out)
            tmp_so = Path(tmp) / so.name
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
            os.replace(tmp_so, so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.walk_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p]
    lib.walk_launch.restype = i
    lib.node_actions_multi_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, p, p, p, i, i, p, p, p, p]
    lib.node_actions_multi_launch.restype = i
    _lib = lib
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_rows(x, name, dtype, B, T, A):
    """(B,T,A) tensor whose rows may be a leading-T slice of a wider node
    axis: unit lane stride, row stride A, any env stride."""
    _check(x.is_cuda, f"{name} must be a CUDA tensor")
    _check(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
    _check(tuple(x.shape) == (B, T, A), f"{name} must be {(B, T, A)}, got {tuple(x.shape)}")
    _check(x.stride(2) == 1 and x.stride(1) == A and x.stride(0) >= T * A,
           f"{name} must have contiguous (T,A) rows")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# walk
# --------------------------------------------------------------------------

def walk_ref(terminal, acts, nxt, max_levels=None):
    """Plain twin of `walk`: the halting test plus `search._walk`."""
    N, T = acts.shape
    B = terminal.shape[0]
    term = terminal[None].expand(N // B, B, T).reshape(N, T)
    halt = (nxt == -1) | torch.gather(term, 1, nxt.long().clamp_min(0))
    return search._walk(acts, nxt, halt, term[:, 0], max_levels=max_levels)


def walk(terminal, acts, nxt, max_levels=None):
    """Root->leaf pointer chase for N = K*B independent rows.

    terminal (B,T) bool (row r reads env r % B; the node axis may be a
    leading slice of a wider one); acts, nxt (N,T) int32, contiguous: each
    node's sampled action and child pointer (-1 unexpanded).
    -> parents, actions, halt_child (N,) int32 and path (N, L) int32, with
    L = min(T, max_levels) levels and -1 past the halting depth. Bit-exact
    with `walk_ref`."""
    if acts.device.type == "cpu":
        return walk_ref(terminal, acts, nxt, max_levels)
    N, T = acts.shape
    B = terminal.shape[0]
    L = T if max_levels is None else min(T, max_levels)
    _check(acts.is_cuda and nxt.is_cuda and terminal.is_cuda, "walk inputs must be CUDA tensors")
    _check(acts.dtype == torch.int32 and nxt.dtype == torch.int32, "acts/nxt must be int32")
    _check(terminal.dtype == torch.bool, "terminal must be bool")
    _check(acts.is_contiguous() and nxt.is_contiguous(), "acts/nxt must be contiguous")
    _check(tuple(nxt.shape) == (N, T), "nxt must match acts")
    _check(B > 0 and N % B == 0 and terminal.shape[1] == T and terminal.stride(1) == 1,
           "terminal must be (B,T) with N = K*B rows and contiguous node rows")
    lib = build()
    dev = acts.device
    parents = torch.empty((N,), dtype=torch.int32, device=dev)
    actions = torch.empty((N,), dtype=torch.int32, device=dev)
    halt_child = torch.empty((N,), dtype=torch.int32, device=dev)
    path = torch.empty((N, L), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.walk_launch(
        acts.data_ptr(), nxt.data_ptr(), terminal.data_ptr(), N, B, T, terminal.stride(0), L,
        parents.data_ptr(), actions.data_ptr(), halt_child.data_ptr(), path.data_ptr(), stream)
    _raise_on(err, "walk")
    walk.launches += 1
    return parents, actions, halt_child, path


walk.launches = 0


# --------------------------------------------------------------------------
# node_actions_multi
# --------------------------------------------------------------------------

def node_actions_multi_ref(logits, n_edge, w_edge, children, rands, c_puct, q_bounds,
                           n_iters=6, accel=True, return_alpha=False):
    """Plain twin of `node_actions_multi`: `search.node_probs` then
    `search._sample_children_multi(cum_mode='shift')`."""
    probs, alpha = search.node_probs(logits, n_edge, w_edge, c_puct, q_bounds,
                                     n_iters=n_iters, accel=accel, return_alpha=True)
    acts, childs = search._sample_children_multi(children, probs, rands.permute(1, 0, 2))
    out = (acts.permute(1, 0, 2).contiguous(), childs.permute(1, 0, 2).contiguous())
    return out + (alpha,) if return_alpha else out


def node_actions_multi(logits, n_edge, w_edge, children, rands, c_puct, q_bounds,
                       n_iters=6, accel=True, return_alpha=False):
    """All-node solve + K draws.

    logits f32, n_edge bf16, w_edge f32, children int8, each (B,T,A) with
    contiguous (T,A) rows (a leading-T slice of a wider node axis is fine);
    rands (B,K,T) f32; c_puct (B,) f32; q_bounds (2,) f32 on the device
    (lo, hi). -> actions, children (B,K,T) int32, plus the solved alpha
    (B,T) f32 when `return_alpha` (a debug output for checking the solve)."""
    if logits.device.type == "cpu":
        return node_actions_multi_ref(logits, n_edge, w_edge, children, rands, c_puct,
                                      q_bounds, n_iters, accel, return_alpha)
    B, T, A = logits.shape
    K = rands.shape[1]
    _check(A <= 128, f"node_actions_multi supports at most 128 actions, got {A}")
    _check_rows(logits, "logits", torch.float32, B, T, A)
    _check_rows(n_edge, "n_edge", torch.bfloat16, B, T, A)
    _check_rows(w_edge, "w_edge", torch.float32, B, T, A)
    _check_rows(children, "children", torch.int8, B, T, A)
    _check(logits.stride(0) == w_edge.stride(0) == n_edge.stride(0) == children.stride(0),
           "tree tensors must share one env stride")
    _check(rands.is_cuda and rands.dtype == torch.float32 and rands.is_contiguous()
           and tuple(rands.shape) == (B, K, T), f"rands must be contiguous (B,K,T)=({B},{K},{T}) f32")
    _check(c_puct.is_cuda and c_puct.dtype == torch.float32 and c_puct.is_contiguous()
           and tuple(c_puct.shape) == (B,), "c_puct must be contiguous (B,) f32")
    _check(q_bounds.is_cuda and q_bounds.dtype == torch.float32 and q_bounds.is_contiguous()
           and q_bounds.numel() == 2, "q_bounds must be a (2,) f32 CUDA tensor")
    lib = build()
    dev = logits.device
    actions = torch.empty((B, K, T), dtype=torch.int32, device=dev)
    childs = torch.empty((B, K, T), dtype=torch.int32, device=dev)
    alpha = torch.empty((B, T), dtype=torch.float32, device=dev) if return_alpha else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.node_actions_multi_launch(
        logits.data_ptr(), n_edge.data_ptr(), w_edge.data_ptr(), children.data_ptr(),
        B, T, A, K, logits.stride(0),
        rands.data_ptr(), c_puct.data_ptr(), q_bounds.data_ptr(), n_iters, int(accel),
        actions.data_ptr(), childs.data_ptr(), alpha.data_ptr() if return_alpha else None,
        stream)
    _raise_on(err, "node_actions_multi")
    node_actions_multi.launches += 1
    return (actions, childs, alpha) if return_alpha else (actions, childs)


node_actions_multi.launches = 0
