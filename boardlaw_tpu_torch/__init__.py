"""PyTorch/CUDA port of boardlaw_tpu.

The JAX package `boardlaw_tpu` is the reference; this package keeps its module
layout so each module has a counterpart there. It imports torch and numpy
only. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.

This first part of the port carries the 9x9 self-play actor step: the Hex
env, the ReZero FCModel, the K-leaf grow-pass MCTS with its two hand-written
kernels (`mcts/kernels.py`, `csrc/`), `learning.mix` and
`train.actor_record`.
"""
