"""The search's hand-written CUDA kernels, their wrappers, their plain
PyTorch twins and their launch counts.

* `walk` (csrc/walk.cu) replaces the Pallas `walk` of
  boardlaw_tpu/mcts/pallas_kernels.py: the root->leaf pointer chase, by the
  design `walk_design` picks for the shape. Twin: `walk_ref`, which is
  `search._walk` after the halting test.
* `node_actions_multi` (csrc/node_actions_multi.cu) replaces the Pallas
  `node_actions_multi`: every node's regularized-policy solve, the log-shift
  prefix sum and K inverse-CDF draws with their child lookups.
  Twin: `node_actions_multi_ref`, which is `search.node_probs` +
  `search._sample_children_multi`.
* `node_actions` (csrc/node_actions.cu) replaces the Pallas `node_actions`:
  the K=1 pass, 16 Newton steps and one draw per node. Twin:
  `search.node_actions`.
* `descend` (csrc/descend.cu) replaces the Pallas `descend`: each env's
  root->leaf walk, solving and sampling only the rows it visits. Twin:
  `search.descend_reference`. No search launches it: it is held against
  its twin and against `node_actions` + `walk`.
* `backup` (csrc/backup.cu) replaces the Pallas `backup`: the leaf->root
  chase updating n, w, n_edge and w_edge in place in one launch, the edges
  routed inside the kernel (the Pallas wrapper routes node deltas in XLA).
  Twin: `search.backup`, bit for bit. The K=1 `search.simulate` launches it
  once a simulation on a tree on the card.
* `backup_dense` (csrc/backup_dense.cu) replaces the Pallas `backup_dense`:
  the same chase with the Pallas kernel's edge value (seat 0's where the
  parent's seat is 0, else seat S-1's). Twin: `search.backup(...,
  edge="dense")`, bit for bit. No search launches it: it is held against
  its twin.
* `backup_prefix` (csrc/backup_prefix.cu) replaces no Pallas kernel: one K>1
  pass's backup of its K recorded walks per env, n, w, n_edge and w_edge in
  place in one launch, where the JAX package contracts path one-hots in
  plain XLA. Twin: `search.backup_paths_prefix`, bit for bit as it runs on
  the card (its scatters' association); on the CPU n, w and n_edge bit for
  bit and w_edge to float32 roundoff (the CPU adds each walk's term to
  w_edge in turn, the card their sum). The K>1 `search.simulate_multi`
  launches it once a pass on a tree on the card.
* `solve_probs` (csrc/solve_probs.cu) replaces the Pallas `solve_probs`: the
  all-node solve alone, probs (B,R,A) or the roots alpha (B,R). Twin:
  `solve_probs_ref`, which is `search.node_probs`.
* `sample_children_multi` (csrc/sample_children_multi.cu) replaces the Pallas
  `sample_children_multi`: the log-shift prefix sum and K draws with their
  child lookups from precomputed probs. Twin: `sample_children_multi_ref`,
  which is `search._sample_children_multi` in the 'shift' order.
* `hex_step` (csrc/hex_step.cu) replaces no Pallas kernel: it is a whole
  `envs.hex.Hex.step` for every board in one launch (the stone, the win
  test, the edge flood run to its fixpoint on the device, the auto-reset),
  where the JAX package runs plain XLA ops and a `lax.while_loop` flood, and
  the twin, `envs.hex.step_reference`, some sixty launches and a flood that
  waits for the host once every four dilations. Bit-equal to the twin.
  `Hex.step` calls it for a board on the card and the twin for one on the
  CPU; the wrapper itself takes CUDA tensors only.

The five row kernels share one device solve, prefix sum and draw
(csrc/row_solve.cuh) and one lane layout (`row_layout`): the split pair
`solve_probs` + `sample_children_multi` draws what the fused
`node_actions_multi` draws, and `descend` walks what `node_actions` + `walk`
walk. `solve_steps` gives the solver steps each row needs, which the kernels
run (a warp until all its rows are done) and the bounds count. The two
backups share one chase (csrc/backup_walk.cuh), a lane group per env, its
width fixed there.

The four kernels that read the tree's logits (`node_actions_multi`,
`node_actions`, `descend`, `solve_probs`) read them in their storage type,
float32 or bfloat16 (`search.MCTSConfig.tree_dtype`), in place: each has a
bf16 instantiation that widens a logit to float32 at its load, so on bf16
logits it computes bit for bit what the f32 kernel computes on their f32
copy, without making that copy. The twins read `logits.float()`.

The kernels that read the tree's children or edge counts take them in the
types of `search.tree_dtypes`' rule: (int8 children, bf16 counts) up to 127
node slots, (int32, bf16) at 128 and (int32, float32) above. Each pair has its instantiation; the int8 one holds a row's
children in registers, the int32 one loads a draw's child after the draw.
A CUDA tensor of another type raises; there is no conversion and no
fallback.

A wrapper given CPU tensors runs the twin (`hex_step` excepted, above); given
CUDA tensors it launches the kernel or raises, with no fallback. Each launch adds one to its
instantiation's entry of `launches` and nowhere else, keyed by `instance`'s
name: the kernel's own name for f32 logits on the compact tree, `.bf16`
after it for bf16 logits, `.wide` for int32 children with f32 counts (or
the one wide type a kernel reads) and `.mixed` for int32 children with bf16
counts, these two followed by `.bf16` where the logits are bf16.

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
_SOURCES = ("walk.cu", "node_actions_multi.cu", "node_actions.cu", "descend.cu", "backup.cu",
            "backup_dense.cu", "backup_prefix.cu", "solve_probs.cu", "sample_children_multi.cu",
            "hex_step.cu")
_HEADERS = ("row_solve.cuh", "backup_walk.cuh")
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
    for s in srcs + [_PKG / "csrc" / h for h in _HEADERS]:
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
    q = ctypes.c_longlong
    lib.walk_launch.argtypes = [p, p, p, i, i, i, q, q, q, i, i, p, p]
    lib.walk_launch.restype = i
    # the row kernels end in (group, blocks, stream): `row_grid`'s layout
    # the logits' kernels take (logits, logits_bf16, ...)
    # and take each tree tensor with its type flag: (logits, logits_bf16,
    # n_edge, counts_f32, w_edge, children, children_i32, ...)
    lib.node_actions_multi_launch.argtypes = [
        p, i, p, i, p, p, i, i, i, i, i, i, p, p, p, i, i, p, p, p, i, i, p]
    lib.node_actions_multi_launch.restype = i
    lib.node_actions_launch.argtypes = [
        p, i, p, i, p, p, i, i, i, i, i, p, p, p, p, p, p, i, i, p]
    lib.node_actions_launch.restype = i
    lib.descend_launch.argtypes = [p, i, p, i, p, p, i, p, i, i, i, p, p, p, p, p, i, i, p]
    lib.descend_launch.restype = i
    for name in ("backup_launch", "backup_dense_launch"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p, p, i, p, p]
        getattr(lib, name).restype = i
    lib.backup_prefix_launch.argtypes = [p, p, q, q, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                         p, p, p, i, p, p]
    lib.backup_prefix_launch.restype = i
    lib.solve_probs_launch.argtypes = [p, i, p, i, p, i, i, i, i, p, p, i, i, i, p, i, i, p]
    lib.solve_probs_launch.restype = i
    lib.sample_children_multi_launch.argtypes = [p, i, p, i, i, i, i, i, i, p, p, p, i, i, p]
    lib.sample_children_multi_launch.restype = i
    lib.hex_step_launch.argtypes = [p, p, p, i, q, i, i, p, p, p, p, p]
    lib.hex_step_launch.restype = i
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


# the storage types of the tree's logits that the row kernels read
LOGITS_DTYPES = (torch.float32, torch.bfloat16)


def _check_logits_dtype(logits):
    _check(logits.dtype in LOGITS_DTYPES,
           f"logits must be float32 or bfloat16, got {logits.dtype}")


def _is_bf16(logits):
    """The launchers' `logits_bf16` flag: 1 for bf16 logits, else 0."""
    return int(logits.dtype == torch.bfloat16)


# the tree's (children, n_edge) storage types the kernels are instantiated
# for: search.tree_dtypes' three pairs
TREE_DTYPES = ((torch.int8, torch.bfloat16), (torch.int32, torch.bfloat16),
               (torch.int32, torch.float32))


def _check_tree_dtypes(children, n_edge):
    """children and n_edge (either may be None) in a pair of
    `TREE_DTYPES`."""
    if children is not None:
        _check(children.dtype in (torch.int8, torch.int32),
               f"children must be int8 or int32, got {children.dtype}")
    if n_edge is not None:
        _check(n_edge.dtype in (torch.bfloat16, torch.float32),
               f"n_edge must be bfloat16 or float32, got {n_edge.dtype}")
    if children is not None and n_edge is not None:
        _check((children.dtype, n_edge.dtype) in TREE_DTYPES,
               f"no kernel takes {children.dtype} children with {n_edge.dtype} edge counts")


def _is_i32(children):
    """The launchers' `children_i32` flag."""
    return int(children.dtype == torch.int32)


def _is_f32(n_edge):
    """The launchers' `counts_f32` flag."""
    return int(n_edge.dtype == torch.float32)


# what each kernel reads of the tree: (l)ogits, (c)hildren, edge cou(n)ts
READS = {"walk": "", "node_actions_multi": "lcn", "node_actions": "lcn", "descend": "lcn",
         "backup": "n", "backup_dense": "n", "backup_prefix": "n", "solve_probs": "ln",
         "sample_children_multi": "c"}


def instance(name, logits=None, children=None, counts=None):
    """The name of kernel `name`'s instantiation (its key in `launches`) for a
    tree whose logits, children and edge counts have these dtypes; those
    the kernel does not read are ignored. `.wide` for f32 counts (or int32
    children where the kernel reads no counts), `.mixed` for int32 children
    with bf16 counts, then `.bf16` for bf16 logits: "node_actions.wide",
    "solve_probs.bf16", "node_actions_multi.mixed.bf16", ..."""
    reads = READS[name]
    tag = ""
    if "n" in reads and counts == torch.float32:
        tag = ".wide"
    elif "c" in reads and children == torch.int32:
        tag = ".mixed" if "n" in reads else ".wide"
    if "l" in reads and logits == torch.bfloat16:
        tag += ".bf16"
    return name + tag


# launches of every instantiation, by `instance`'s name: "walk",
# "node_actions.bf16", "descend.wide", "node_actions_multi.mixed.bf16", ...
launches = dict.fromkeys((instance(name, logits, children, counts) for name in READS
                          for logits in LOGITS_DTYPES for children, counts in TREE_DTYPES), 0)
launches["hex_step"] = 0


def _launched(name, logits=None, children=None, n_edge=None):
    """Count one launch of kernel `name`'s instantiation for these
    tensors."""
    dtypes = (None if x is None else x.dtype for x in (logits, children, n_edge))
    launches[instance(name, *dtypes)] += 1


def _check_tree_rows(logits, n_edge, w_edge, children, B, T, A):
    """The solve's (B,T,A) row inputs (children may be None) in their
    storage types, sharing one env stride; logits f32 or bf16, children and
    n_edge a pair of `TREE_DTYPES`."""
    _check_logits_dtype(logits)
    _check_tree_dtypes(children, n_edge)
    _check_rows(logits, "logits", logits.dtype, B, T, A)
    _check_rows(n_edge, "n_edge", n_edge.dtype, B, T, A)
    _check_rows(w_edge, "w_edge", torch.float32, B, T, A)
    strides = {logits.stride(0), n_edge.stride(0), w_edge.stride(0)}
    if children is not None:
        _check_rows(children, "children", children.dtype, B, T, A)
        strides.add(children.stride(0))
    _check(len(strides) == 1, "tree tensors must share one env stride")


def _check_bounds(c_puct, q_bounds, B):
    _check(c_puct.is_cuda and c_puct.dtype == torch.float32 and c_puct.is_contiguous()
           and tuple(c_puct.shape) == (B,), "c_puct must be contiguous (B,) f32")
    _check(q_bounds.is_cuda and q_bounds.dtype == torch.float32 and q_bounds.is_contiguous()
           and q_bounds.numel() == 2, "q_bounds must be a (2,) f32 CUDA tensor")


def _check_solve_args(rands, c_puct, q_bounds, rands_shape):
    _check(rands.is_cuda and rands.dtype == torch.float32 and rands.is_contiguous()
           and tuple(rands.shape) == rands_shape, f"rands must be contiguous {rands_shape} f32")
    _check_bounds(c_puct, q_bounds, rands_shape[0])


def _check_stored(x, name, dtype, shape):
    """A whole (B,T,...) tree tensor in its storage type, contiguous. The
    message is built only on failure: the K=1 search calls this on every
    launch, and its host time is the search's."""
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.shape != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {tuple(shape)}, got {tuple(x.shape)}")


def _check_node(x, name, dtype, shape):
    """`_check_stored`, on the card."""
    _check_stored(x, name, dtype, shape)
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# The row kernels' lane layout and solver steps
# --------------------------------------------------------------------------

WARPS_PER_BLOCK = 8  # csrc/row_solve.cuh kWarpsPerBlock
ROW_MAX_J = 8  # csrc/row_solve.cuh kMaxJ: the most actions a lane holds


def row_layout(A):
    """The row kernels' lane layout for rows of A actions: (G, J), a row to
    each group of G lanes (32/G rows a warp), J = ceil(A/G) actions a lane.
    Rows share a warp so that its lanes are busy and a sum takes log2(G)
    shuffles. This is the one place G is chosen; the launchers check that
    the row fits. G is the faster width measured on the H100 for every board
    from 3x3 to 11x11 (scripts/torch_row_layout.py): 8 lanes up to A = 64,
    16 above."""
    _check(0 < A <= 16 * ROW_MAX_J, f"the row kernels support 1 to 128 actions, got {A}")
    G = 8 if A <= 64 else 16
    return G, -(-A // G)


def row_grid(n_rows, A):
    """(G, blocks): the lane-group width and the grid of a row kernel over
    n_rows rows (or envs), each row in one group of one warp."""
    G, _ = row_layout(A)
    per_block = WARPS_PER_BLOCK * (32 // G)
    return G, -(-n_rows // per_block)


def solve_steps(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=16, accel=False):
    """The solver steps each node row needs, (B,T) int32: the step in which
    its convergence test first holds (counted from 1), else n_iters. The
    row kernels stop there (a warp once all its rows have), and running
    `search.node_probs` for that many steps gives the full solve's alpha bit
    for bit."""
    B, T, A = logits.shape
    q, counts = search._edge_q_counts(n_edge, w_edge, q_bounds)
    N = counts.sum(-1)
    lam = c_puct[:, None] * N / (N + A)
    _, _, steps = search.solve_policy(torch.exp(logits.float()).reshape(B * T, A),
                                      q.reshape(B * T, A), lam.reshape(B * T), n_iters=n_iters,
                                      accel=accel, return_steps=True)
    return steps.reshape(B, T)


# --------------------------------------------------------------------------
# walk
# --------------------------------------------------------------------------

def walk_ref(terminal, acts, nxt, max_levels=None):
    """Plain twin of `walk`: the halting test plus `search._walk`. acts and
    nxt as `walk` takes them; a (K,B,R) view is copied to rows here."""
    if acts.dim() == 3:
        K, B, R = acts.shape
        acts, nxt = acts.reshape(K * B, R), nxt.reshape(K * B, R)
    N, T = acts.shape
    B = terminal.shape[0]
    term = terminal[None].expand(N // B, B, T).reshape(N, T)
    halt = (nxt == -1) | torch.gather(term, 1, nxt.long().clamp_min(0))
    return search._walk(acts, nxt, halt, term[:, 0], max_levels=max_levels)


# csrc/walk.cu's two designs, by the number walk_launch takes
WALK_DESIGNS = {"block": 0, "chase": 1, "gather": 2}


def walk_design(K, R):
    """The walk kernel's design for K walks per env over rows of R nodes, the
    one place it is chosen: 'block' (each env's rows and terminal row copied
    to shared memory, chased there), 'gather' (the terminal row in shared
    memory, the rows chased in device memory) or 'chase' (a thread per row,
    all in device memory). Each is the fastest measured on the H100 at 32,768
    envs (scripts/torch_walk_bytes.py, chip_smoke.py): 'block' for K = 1
    (rows of up to 64 nodes, walks up to 63 deep); for K = 8, 'chase' on the
    first grow pass's 9 rows, where every walk stops at the root, and
    'gather' from 17 rows up, on every grow and scan pass after it."""
    if K == 1:
        return "block"
    return "chase" if R <= 9 else "gather"


def _walk_rows(terminal, acts, nxt):
    """(K, B, R, K stride, B stride) of `walk`'s inputs, or a ValueError
    naming what is wrong. The common case costs a few attribute reads: the
    K=1 search calls this on every sim."""
    B = terminal.shape[0]
    if acts.dim() == 2:
        N, R = acts.shape
        K = N // B if B else 0
        ok = K * B == N and acts.is_contiguous()
        sK, sB = B * R, R
    elif acts.dim() == 3:
        K, B3, R = acts.shape
        sK, sB, s2 = acts.stride()
        ok = B3 == B and (s2 == 1 or R == 1)
    else:
        K = B3 = R = sK = sB = ok = 0
    if (ok and B > 0 and acts.dtype is torch.int32 and nxt.dtype is torch.int32
            and nxt.shape == acts.shape and nxt.stride() == acts.stride()
            and terminal.dtype is torch.bool and terminal.dim() == 2 and terminal.shape[1] == R
            and terminal.stride(1) == 1 and acts.is_cuda and nxt.is_cuda and terminal.is_cuda):
        return K, B, R, sK, sB
    _check(acts.is_cuda and nxt.is_cuda and terminal.is_cuda, "walk inputs must be CUDA tensors")
    _check(acts.dtype == torch.int32 and nxt.dtype == torch.int32, "acts/nxt must be int32")
    _check(terminal.dtype == torch.bool, "terminal must be bool")
    _check(acts.dim() in (2, 3), "acts/nxt must be (N,R) rows or a (K,B,R) view")
    _check(nxt.shape == acts.shape and nxt.stride() == acts.stride(),
           "nxt must match acts in shape and strides")
    _check(acts.dim() == 3 or acts.is_contiguous(), "(N,R) acts/nxt must be contiguous")
    _check(acts.dim() == 2 or acts.stride(2) == 1, "(K,B,R) acts/nxt need a contiguous last axis")
    _check(B > 0 and terminal.dim() == 2 and terminal.shape[1] == R and terminal.stride(1) == 1,
           "terminal must be (B,R) with contiguous node rows")
    _check(False, "acts/nxt must hold K*B rows of terminal's B envs")


def walk(terminal, acts, nxt, max_levels=None):
    """Root->leaf pointer chase of K walks per env.

    terminal (B,R) bool (the node axis may be a leading slice of a wider
    one); acts, nxt int32, each node's sampled action and child pointer (-1
    unexpanded), either as N = K*B contiguous (N,R) rows (row r reads env
    r % B) or as a (K,B,R) view with a contiguous last axis and any K and B
    strides (the sampler's (B,K,R) buffer, permuted).
    -> parents, actions, halt_child (K*B,) int32 and path (K*B, L) int32 in
    k-major row order, with L = min(R, max_levels) levels and -1 past the
    halting depth: views of one packed buffer. Bit-exact with `walk_ref`."""
    if acts.device.type == "cpu":
        return walk_ref(terminal, acts, nxt, max_levels)
    return _walk_launch(terminal, acts, nxt, max_levels)


def _walk_launch(terminal, acts, nxt, max_levels, design=None):
    """`walk` on the card, by `design` ('block' or 'chase'; None:
    `walk_design`'s)."""
    K, B, R, sK, sB = _walk_rows(terminal, acts, nxt)
    L = R if max_levels is None else min(R, max_levels)
    N = K * B
    out = torch.empty(((3 + L) * N,), dtype=torch.int32, device=acts.device)
    err = build().walk_launch(
        acts.data_ptr(), nxt.data_ptr(), terminal.data_ptr(), K, B, R, sK, sB,
        terminal.stride(0), L, WALK_DESIGNS[design or walk_design(K, R)], out.data_ptr(),
        torch.cuda.current_stream(acts.device).cuda_stream)
    _raise_on(err, "walk")
    launches["walk"] += 1
    return out[:N], out[N:2 * N], out[2 * N:3 * N], out[3 * N:].view(N, L)


# --------------------------------------------------------------------------
# node_actions_multi
# --------------------------------------------------------------------------

def node_actions_multi_ref(logits, n_edge, w_edge, children, rands, c_puct, q_bounds,
                           n_iters=6, accel=True, return_alpha=False):
    """Plain twin of `node_actions_multi`: `search.node_probs` then
    `search._sample_children_multi` (the log-shift order)."""
    probs, alpha = search.node_probs(logits, n_edge, w_edge, c_puct, q_bounds,
                                     n_iters=n_iters, accel=accel, return_alpha=True)
    acts, childs = search._sample_children_multi(children, probs, rands.permute(1, 0, 2))
    out = (acts.permute(1, 0, 2).contiguous(), childs.permute(1, 0, 2).contiguous())
    return out + (alpha,) if return_alpha else out


def node_actions_multi(logits, n_edge, w_edge, children, rands, c_puct, q_bounds,
                       n_iters=6, accel=True, return_alpha=False):
    """All-node solve + K draws.

    logits f32 or bf16, n_edge bf16 or f32, w_edge f32, children int8 or
    int32 (a pair of `TREE_DTYPES`), each (B,T,A) with contiguous (T,A) rows
    (a leading-T slice of a wider node axis is fine); rands (B,K,T) f32;
    c_puct (B,) f32; q_bounds (2,) f32 on
    the device (lo, hi). -> actions, children (B,K,T) int32, plus the solved alpha
    (B,T) f32 when `return_alpha` (a debug output for checking the solve)."""
    if logits.device.type == "cpu":
        return node_actions_multi_ref(logits, n_edge, w_edge, children, rands, c_puct,
                                      q_bounds, n_iters, accel, return_alpha)
    B, T, A = logits.shape
    K = rands.shape[1]
    _check_tree_rows(logits, n_edge, w_edge, children, B, T, A)
    _check_solve_args(rands, c_puct, q_bounds, (B, K, T))
    lib = build()
    dev = logits.device
    actions = torch.empty((B, K, T), dtype=torch.int32, device=dev)
    childs = torch.empty((B, K, T), dtype=torch.int32, device=dev)
    alpha = torch.empty((B, T), dtype=torch.float32, device=dev) if return_alpha else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.node_actions_multi_launch(
        logits.data_ptr(), _is_bf16(logits), n_edge.data_ptr(), _is_f32(n_edge),
        w_edge.data_ptr(), children.data_ptr(), _is_i32(children), B, T, A, K, logits.stride(0),
        rands.data_ptr(), c_puct.data_ptr(), q_bounds.data_ptr(), n_iters, int(accel),
        actions.data_ptr(), childs.data_ptr(), alpha.data_ptr() if return_alpha else None,
        *row_grid(B * T, A), stream)
    _raise_on(err, "node_actions_multi")
    _launched("node_actions_multi", logits, children, n_edge)
    return (actions, childs, alpha) if return_alpha else (actions, childs)


# --------------------------------------------------------------------------
# node_actions (K=1)
# --------------------------------------------------------------------------

def node_actions(logits, n_edge, w_edge, children, rands, c_puct, q_bounds,
                 return_alpha=False):
    """The K=1 all-node solve (up to 16 Newton steps, one-sided test) and
    one draw per node.

    logits f32 or bf16, n_edge bf16 or f32, w_edge f32, children int8 or
    int32 (a pair of `TREE_DTYPES`), each (B,T,A) with contiguous (T,A) rows
    (a leading-T slice of a wider node axis is fine); rands (B,T) f32;
    c_puct (B,) f32; q_bounds (2,) f32 on the device. -> actions, children
    (B,T) int32, plus the roots alpha (B,T) f32 the draws used when
    `return_alpha` (a debug output for checking the solve)."""
    if logits.device.type == "cpu":
        if not return_alpha:
            return search.node_actions(logits, n_edge, w_edge, children, rands, c_puct,
                                       q_bounds)
        probs, alpha = search.node_probs(logits, n_edge, w_edge, c_puct, q_bounds,
                                         return_alpha=True)
        return search._sample_children(children, probs, rands) + (alpha,)
    B, T, A = logits.shape
    _check_tree_rows(logits, n_edge, w_edge, children, B, T, A)
    _check_solve_args(rands, c_puct, q_bounds, (B, T))
    lib = build()
    dev = logits.device
    actions = torch.empty((B, T), dtype=torch.int32, device=dev)
    childs = torch.empty((B, T), dtype=torch.int32, device=dev)
    alpha = torch.empty((B, T), dtype=torch.float32, device=dev) if return_alpha else None
    err = lib.node_actions_launch(
        logits.data_ptr(), _is_bf16(logits), n_edge.data_ptr(), _is_f32(n_edge),
        w_edge.data_ptr(), children.data_ptr(), _is_i32(children), B, T, A, logits.stride(0),
        rands.data_ptr(), c_puct.data_ptr(),
        q_bounds.data_ptr(), actions.data_ptr(), childs.data_ptr(),
        alpha.data_ptr() if return_alpha else None, *row_grid(B * T, A),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "node_actions")
    _launched("node_actions", logits, children, n_edge)
    return (actions, childs, alpha) if return_alpha else (actions, childs)


# --------------------------------------------------------------------------
# descend (K=1)
# --------------------------------------------------------------------------

def descend(tree, rands):
    """Each env's root->leaf walk over `tree` (a `search.Tree`), solving and
    sampling each visited row with rands (B,T) f32 -> (parents, actions)
    (B,) int32; the tree's logits f32 or bf16, its children and n_edge a
    pair of `TREE_DTYPES`. Bit-equal to
    `search.node_actions` + `walk` on the same tree and rands."""
    if rands.device.type == "cpu":
        return search.descend_reference(tree, rands)
    B, T, A = tree.logits.shape
    _check_logits_dtype(tree.logits)
    _check_tree_dtypes(tree.children, tree.n_edge)
    _check_node(tree.logits, "logits", tree.logits.dtype, (B, T, A))
    _check_node(tree.n_edge, "n_edge", tree.n_edge.dtype, (B, T, A))
    _check_node(tree.w_edge, "w_edge", torch.float32, (B, T, A))
    _check_node(tree.children, "children", tree.children.dtype, (B, T, A))
    _check_node(tree.terminal, "terminal", torch.bool, (B, T))
    q_bounds = search._q_bounds(tree)
    _check_solve_args(rands, tree.c_puct, q_bounds, (B, T))
    lib = build()
    dev = rands.device
    parents = torch.empty((B,), dtype=torch.int32, device=dev)
    actions = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.descend_launch(
        tree.logits.data_ptr(), _is_bf16(tree.logits), tree.n_edge.data_ptr(),
        _is_f32(tree.n_edge), tree.w_edge.data_ptr(), tree.children.data_ptr(),
        _is_i32(tree.children), tree.terminal.data_ptr(), B, T, A,
        rands.data_ptr(), tree.c_puct.data_ptr(), q_bounds.data_ptr(), parents.data_ptr(),
        actions.data_ptr(), *row_grid(B, A), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "descend")
    _launched("descend", tree.logits, tree.children, tree.n_edge)
    return parents, actions


# --------------------------------------------------------------------------
# backup and backup_dense (K=1), backup_prefix (K>1)
# --------------------------------------------------------------------------

def _check_backup_tensors(tensors, S, n_per_visit):
    """The backup kernels' checks: each (name, tensor, dtype, shape) of
    `tensors` in its storage type, whole and contiguous, at most 4 seats and
    a whole `n_per_visit`, then each tensor on the card: storage type and
    shape first, so the refusals are testable on the CPU."""
    for name, x, dtype, shape in tensors:
        _check_stored(x, name, dtype, shape)
    if S > 4:
        raise ValueError(f"the backup kernels take at most 4 seats, got {S}")
    if int(n_per_visit) != n_per_visit:
        raise ValueError(f"n_per_visit must be whole, got {n_per_visit}")
    for name, x, _, _ in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")


def _check_backup(tree, leaves, n_per_visit):
    """Every tensor the K=1 backup kernels read or write, in its storage
    type (n_edge bf16 or f32), whole and contiguous, on the card
    (`_check_backup_tensors`). Returns (B, T, A, S)."""
    B, T, S = tree.w.shape
    A = tree.n_edge.shape[-1]
    _check_stored(leaves, "leaves", torch.int32, (B,))
    _check_tree_dtypes(None, tree.n_edge)
    stored = (("v", torch.float32, (B, T, S)), ("parents", torch.int32, (B, T)),
              ("relation", torch.int32, (B, T)), ("seats", torch.int32, (B, T)),
              ("terminal", torch.bool, (B, T)), ("rewards", torch.float32, (B, T, S)),
              ("n", torch.int32, (B, T)), ("w", torch.float32, (B, T, S)),
              ("n_edge", tree.n_edge.dtype, (B, T, A)), ("w_edge", torch.float32, (B, T, A)))
    _check_backup_tensors(((("leaves", leaves, torch.int32, (B,)),)
                           + tuple((name, getattr(tree, name), dtype, shape)
                                   for name, dtype, shape in stored)), S, n_per_visit)
    return B, T, A, S


def _backup_launch(name, tree, leaves, n_per_visit):
    """Launch the backup kernel `name` ('backup' or 'backup_dense') on
    `tree`, in place."""
    B, T, A, S = _check_backup(tree, leaves, n_per_visit)
    lib = build()
    err = getattr(lib, f"{name}_launch")(
        tree.v.data_ptr(), leaves.data_ptr(), tree.parents.data_ptr(), tree.relation.data_ptr(),
        tree.seats.data_ptr(), tree.terminal.data_ptr(), tree.rewards.data_ptr(), B, T, A, S,
        int(n_per_visit), tree.n.data_ptr(), tree.w.data_ptr(), tree.n_edge.data_ptr(),
        _is_f32(tree.n_edge), tree.w_edge.data_ptr(),
        torch.cuda.current_stream(leaves.device).cuda_stream)
    _raise_on(err, name)


def backup(tree, leaves, n_per_visit):
    """Back up each env's leaf (B,) int32 to the root, in place, in one
    launch: n, w and the parent edges' n_edge, w_edge along each path, the
    edge value at the parent's seat clamped to [0, S-1] (up to 4 seats).
    Bit-equal to `search.backup`. Returns the tree."""
    if leaves.device.type == "cpu":
        return search.backup(tree, leaves, n_per_visit)
    _backup_launch("backup", tree, leaves, n_per_visit)
    _launched("backup", n_edge=tree.n_edge)
    return tree


def backup_dense(tree, leaves, n_per_visit):
    """`backup` with the Pallas `backup_dense`'s edge value: v[0] where the
    parent's seat is 0 and v[S-1] otherwise, for 1 to 4 seats. Bit-equal to
    `search.backup(..., edge="dense")`, which equals `search.backup` for one
    and two seats. Returns the tree."""
    S = tree.w.shape[-1]
    _check(1 <= S <= 4, f"backup_dense takes 1 to 4 seats, got {S}")
    if leaves.device.type == "cpu":
        return search.backup(tree, leaves, n_per_visit, edge="dense")
    _backup_launch("backup_dense", tree, leaves, n_per_visit)
    _launched("backup_dense", n_edge=tree.n_edge)
    return tree


def _check_backup_prefix(tree, paths, acts, leaves, n_per_visit):
    """Every tensor the `backup_prefix` kernel reads or writes: paths
    (K,B,L) and leaves (K,B) int32, the tree's v, prew, terminal, rewards,
    seats, n, w, n_edge (bf16 or f32) and w_edge in their storage types,
    whole and contiguous; acts int32 (K,B,R), 1 <= R <= T, with a
    contiguous last axis and any K and B strides; at most 4 seats; all on
    the card, checked last. Returns (K, B, L, R, T, A, S)."""
    B, T, S = tree.w.shape
    A = tree.n_edge.shape[-1]
    _check(paths.dim() == 3, f"paths must be (K,B,L), got {tuple(paths.shape)}")
    K, _, L = paths.shape
    _check(tree.prew is not None, "the tree has no prew: the prefix backup needs "
                                  "backup_mode='prefix'")
    _check(acts.dtype == torch.int32, f"acts must be torch.int32, got {acts.dtype}")
    _check(acts.dim() == 3 and tuple(acts.shape[:2]) == (K, B) and 1 <= acts.shape[2] <= T
           and (acts.stride(2) == 1 or acts.shape[2] == 1),
           f"acts must be a (K,B,R) view with R <= {T} and a contiguous last axis, "
           f"got {tuple(acts.shape)}")
    _check_tree_dtypes(None, tree.n_edge)
    stored = (("v", torch.float32, (B, T, S)), ("prew", torch.float32, (B, T, S)),
              ("terminal", torch.bool, (B, T)), ("rewards", torch.float32, (B, T, S)),
              ("seats", torch.int32, (B, T)), ("n", torch.int32, (B, T)),
              ("w", torch.float32, (B, T, S)), ("n_edge", tree.n_edge.dtype, (B, T, A)),
              ("w_edge", torch.float32, (B, T, A)))
    _check_backup_tensors(((("paths", paths, torch.int32, (K, B, L)),
                            ("leaves", leaves, torch.int32, (K, B)))
                           + tuple((name, getattr(tree, name), dtype, shape)
                                   for name, dtype, shape in stored)), S, n_per_visit)
    _check(acts.is_cuda, "acts must be a CUDA tensor")
    return K, B, L, acts.shape[2], T, A, S


def backup_prefix(tree, paths, acts, leaves, n_per_visit):
    """Back up one K>1 pass in place, in one launch: paths (K,B,L) int32
    the walks' interior nodes (-1 padded, as `walk` records them), acts
    (K,B,R) int32 the sampled action of each node row (the (K,B,R) view of
    `node_actions_multi`'s (B,K,R) buffer as it is), leaves (K,B) int32.
    n, w, n_edge and w_edge take the prefix identity's deltas at the path
    nodes, their edges and the leaves only, each node and edge summed in
    walk order as the twin's scatters sum them on the card: bit-equal to
    `search.backup_paths_prefix` run on the card, up to 4 seats (on the CPU
    the twin's w_edge differs by float32 roundoff). The paths must be a
    search's: a node of an env at one level, no leaf on a path. Returns the
    tree."""
    if leaves.device.type == "cpu":
        return search.backup_paths_prefix(tree, paths, acts, leaves, n_per_visit)
    K, B, L, R, T, A, S = _check_backup_prefix(tree, paths, acts, leaves, n_per_visit)
    err = build().backup_prefix_launch(
        paths.data_ptr(), acts.data_ptr(), acts.stride(0), acts.stride(1), leaves.data_ptr(),
        tree.v.data_ptr(), tree.prew.data_ptr(), tree.terminal.data_ptr(),
        tree.rewards.data_ptr(), tree.seats.data_ptr(), B, T, A, S, K, L, R, int(n_per_visit),
        tree.n.data_ptr(), tree.w.data_ptr(), tree.n_edge.data_ptr(), _is_f32(tree.n_edge),
        tree.w_edge.data_ptr(), torch.cuda.current_stream(leaves.device).cuda_stream)
    _raise_on(err, "backup_prefix")
    _launched("backup_prefix", n_edge=tree.n_edge)
    return tree


# --------------------------------------------------------------------------
# solve_probs and sample_children_multi (the split K>1 solve and sampler)
# --------------------------------------------------------------------------

def solve_probs_ref(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=6, accel=True,
                    out="probs"):
    """Plain twin of `solve_probs`: `search.node_probs`."""
    probs, alpha = search.node_probs(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=n_iters,
                                     accel=accel, return_alpha=True)
    return alpha if out == "alpha" else probs


def solve_probs(logits, n_edge, w_edge, c_puct, q_bounds, n_iters=6, accel=True, out="probs"):
    """The all-node solve alone.

    logits f32 or bf16, n_edge bf16 or f32, w_edge f32, each (B,R,A) with
    contiguous (R,A) rows and one env stride (a leading-R slice of a wider node axis is
    fine); c_puct (B,) f32; q_bounds (2,) f32 on the device (lo, hi).
    -> probs (B,R,A) f32, contiguous, or with out="alpha" the roots (B,R)
    f32, the same floats as `node_actions_multi(..., return_alpha=True)`'s."""
    _check(out in ("probs", "alpha"), f"out must be 'probs' or 'alpha', got {out!r}")
    if logits.device.type == "cpu":
        return solve_probs_ref(logits, n_edge, w_edge, c_puct, q_bounds, n_iters, accel, out)
    B, R, A = logits.shape
    _check_tree_rows(logits, n_edge, w_edge, None, B, R, A)
    _check_bounds(c_puct, q_bounds, B)
    lib = build()
    dev = logits.device
    res = torch.empty((B, R) if out == "alpha" else (B, R, A), dtype=torch.float32, device=dev)
    err = lib.solve_probs_launch(
        logits.data_ptr(), _is_bf16(logits), n_edge.data_ptr(), _is_f32(n_edge),
        w_edge.data_ptr(), B, R, A, logits.stride(0),
        c_puct.data_ptr(), q_bounds.data_ptr(), n_iters, int(accel), int(out == "alpha"),
        res.data_ptr(), *row_grid(B * R, A), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "solve_probs")
    _launched("solve_probs", logits, n_edge=n_edge)
    return res


def sample_children_multi_ref(probs, children, rands):
    """Plain twin of `sample_children_multi`:
    `search._sample_children_multi` in the 'shift' order."""
    acts, childs = search._sample_children_multi(children, probs, rands.permute(1, 0, 2),
                                                 cum_mode="shift")
    return acts.permute(1, 0, 2).contiguous(), childs.permute(1, 0, 2).contiguous()


def sample_children_multi(probs, children, rands):
    """K draws per node row from solved probs.

    probs (B,R,A) f32 and children (B,R,A) int8 or int32, each with contiguous (R,A)
    rows (a leading-R slice of a wider node axis is fine); rands (B,K,R)
    f32. -> actions, child (B,K,R) int32; bit-equal to the twin."""
    if probs.device.type == "cpu":
        return sample_children_multi_ref(probs, children, rands)
    B, R, A = probs.shape
    K = rands.shape[1]
    _check_rows(probs, "probs", torch.float32, B, R, A)
    _check_tree_dtypes(children, None)
    _check_rows(children, "children", children.dtype, B, R, A)
    _check(rands.is_cuda and rands.dtype == torch.float32 and rands.is_contiguous()
           and rands.dim() == 3 and tuple(rands.shape) == (B, K, R),
           f"rands must be contiguous {(B, K, R)} f32")
    lib = build()
    dev = probs.device
    actions = torch.empty((B, K, R), dtype=torch.int32, device=dev)
    childs = torch.empty((B, K, R), dtype=torch.int32, device=dev)
    err = lib.sample_children_multi_launch(
        probs.data_ptr(), probs.stride(0), children.data_ptr(), _is_i32(children),
        children.stride(0), B, R, A, K,
        rands.data_ptr(), actions.data_ptr(), childs.data_ptr(), *row_grid(B * R, A),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "sample_children_multi")
    _launched("sample_children_multi", children=children)
    return actions, childs


# --------------------------------------------------------------------------
# hex_step
# --------------------------------------------------------------------------

HEX_MAX_SIZE = 11  # csrc/hex_step.cu kMaxSize: the largest board the kernel takes


def _check_hex_step(board, seats, actions):
    """`hex_step`'s inputs: storage type and shape first, then the device,
    so the refusals are testable on the CPU. The messages are built only on
    failure: every `Hex.step` on the card calls this. Returns (B, S)."""
    if board.dtype != torch.uint8:
        raise ValueError(f"board must be uint8, got {board.dtype}")
    if board.dim() != 3 or board.shape[1] != board.shape[2] or not board.is_contiguous():
        raise ValueError(f"board must be a contiguous (B,S,S) tensor, got {tuple(board.shape)}")
    B, S = board.shape[0], board.shape[1]
    if not 1 <= S <= HEX_MAX_SIZE:
        raise ValueError(f"the hex_step kernel takes boards of 1 to {HEX_MAX_SIZE} cells a side, "
                         f"got {S}")
    _check_stored(seats, "seats", torch.int32, (B,))
    if actions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"actions must be int32 or int64, got {actions.dtype}")
    if actions.shape != (B,) or not actions.is_contiguous():
        raise ValueError(f"actions must be contiguous {(B,)}, got {tuple(actions.shape)}")
    for name, x in (("board", board), ("seats", seats), ("actions", actions)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    if seats.device != board.device or actions.device != board.device:
        raise ValueError("board, seats and actions must be on one card")
    return B, S


def hex_step(board, seats, actions, reset=True):
    """A whole `Hex.step` of every board on the card, in one launch: the
    stone, the win test, the edge flood to its fixpoint and, with `reset`,
    the auto-reset of won boards, with no wait for the host.

    board (B,S,S) uint8 with 1 <= S <= HEX_MAX_SIZE, seats (B,) int32,
    actions (B,) int32 or int64 flat in the mover's frame, all contiguous
    CUDA tensors. -> (board (B,S,S) uint8, seats (B,) int32, rewards (B,2)
    f32, terminal (B,) bool), bit-equal to `envs.hex.step_reference`, its
    twin. CUDA tensors only: `Hex.step` takes the twin for a board on the
    CPU."""
    B, S = _check_hex_step(board, seats, actions)
    dev = board.device
    new_board = torch.empty_like(board)
    new_seats = torch.empty_like(seats)
    rewards = torch.empty((B, 2), dtype=torch.float32, device=dev)
    terminal = torch.empty((B,), dtype=torch.bool, device=dev)
    err = build().hex_step_launch(
        board.data_ptr(), seats.data_ptr(), actions.data_ptr(), int(actions.dtype == torch.int64),
        B, S, int(reset), new_board.data_ptr(), new_seats.data_ptr(), rewards.data_ptr(),
        terminal.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hex_step")
    launches["hex_step"] += 1
    return new_board, new_seats, rewards, terminal
