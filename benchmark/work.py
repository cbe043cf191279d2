"""The work a cell's shapes need, counted from its configuration alone, so
that a kernel's roofline reads the same work whatever implements it; and
the card's published peaks.

The byte counts are the ones the port's kernels were designed against (the
solve-and-draw kernels' bytes: each input byte read once, each output byte
written once, in the tree's storage types). The solve's operations stay
under its bytes bound even at the most solver steps (about 14 FLOP a
byte for K = 1 against the card's 20), so the bound is the bytes'.
"""
from __future__ import annotations

from .reference import nets

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def tree_size(n_nodes, K):
    """Node slots: K a pass plus the root."""
    return 1 + K * (-(-(n_nodes - 1) // K))


def n_passes(n_nodes, K):
    return -(-(n_nodes - 1) // K)


def pass_shape(n_nodes, K, p):
    """(rows, levels) of grow pass p: the first 1 + (p+1)K rows, p+2
    levels."""
    return min(tree_size(n_nodes, K), 1 + (p + 1) * K), p + 2


def tree_types(T):
    """(children, edge counts) bytes per entry: int8 children up to 127
    slots, else int32; bf16 counts while 2T <= 256, else float32."""
    return (1 if T <= 127 else 4), (2 if 2 * T <= 256 else 4)


def macs(cfg):
    """The multiply-adds of one evaluation of the configuration's network,
    as its module (`reference/nets/`) counts them."""
    return nets.module(cfg).macs(cfg)


def node_actions_bytes(B, R, A, K, T, logit_bytes=4):
    """Bytes of one solve-and-draw call over R rows of B envs with K draws a
    row: the (R, A) rows of logits, edge counts and edge values, the drawn
    children, the uniforms, c_puct and the bounds read; actions and
    children written."""
    child, count = tree_types(T)
    row = logit_bytes + count + 4
    return B * R * (A * row + min(K, A) * child) + B * K * R * 4 + B * 4 + 8 + 2 * B * K * R * 4


def search_calls(cfg):
    """[(R, K)] of the solve-and-draw calls of one search: each grow pass
    for K > 1, each simulation's live rows for K = 1."""
    K, n = cfg["leaves_per_pass"], cfg["n_nodes"]
    if K == 1:
        return [(i + 1, 1) for i in range(n - 1)]
    return [(pass_shape(n, K, p)[0], K) for p in range(n_passes(n, K))]


def search_bytes(cfg, B):
    """Bytes of every solve-and-draw call of one search over B envs, the
    logits in the tree's storage type (`tree_dtype`)."""
    A = cfg["boardsize"] ** 2
    T = tree_size(cfg["n_nodes"], cfg["leaves_per_pass"])
    logit = 2 if cfg.get("tree_dtype") == "bfloat16" else 4
    return sum(node_actions_bytes(B, R, A, K, T, logit) for R, K in search_calls(cfg))


def evaluations(cfg):
    """Network evaluations one search makes per env: the root and every
    leaf (K a pass, duplicates included)."""
    K, n = cfg["leaves_per_pass"], cfg["n_nodes"]
    return 1 + (n - 1 if K == 1 else K * n_passes(n, K))


def train_step_flops(cfg):
    """Model FLOPs of one train step: 2 a multiply-add for each evaluation
    the search needs, 6 a multiply-add for each learner sample (forward and
    backward)."""
    return macs(cfg) * cfg["n_envs"] * (2 * evaluations(cfg) + 6)


def search_flops(cfg, B):
    return 2 * macs(cfg) * B * evaluations(cfg)
