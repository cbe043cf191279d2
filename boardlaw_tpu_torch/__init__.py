"""PyTorch/CUDA port of boardlaw_tpu.

The JAX package `boardlaw_tpu` is the reference; this package keeps its module
layout so each module has a counterpart there. It imports torch and numpy
only. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.

The port carries the learner's `train.train_step` for `train.run`'s
configurations: the Hex env, the ReZero FCModel (float32 or bf16 compute)
with the space-driven heads, AlphaGo Zero's convolutional tower with batch
norm (`networks.AZTower`, `TrainConfig.net="az"`; no JAX counterpart), the
sequential K=1 MCTS (boards below 7) and the K-leaf MCTS (7 and up; grow or scan passes, a fused or split solve and
sampler; float32 or bf16 tree logits) with their eight hand-written kernels
(`mcts/kernels.py`, `csrc/`), the returns, entropy and noise-scale utilities
of `learning`, and the circular buffer, losses and Adam step of `train`.
`train.make_config`/`best_config` give `run`'s configs, and with
`dtype="bfloat16", tree_dtype="bfloat16"` the JAX flagship's.

`train.run`/`run_best` train an agent and keep it: a run directory in the
JAX package's layout (`pavlov`: run registry, stats, logs, checkpoints),
log-spaced snapshots (`storage`) and `resume=`, for the port's runs and the
JAX package's. `envs/hex.py` also carries `from_string` and the one-player
worlds, and `envs/validation.py` the planted-value games and proxy agents.

Evaluation (`arena/`, `elos`, `activelo/`) rates a run's agents; the
results database (`sql`, in the JAX package's SQLite schema) holds runs,
snapshots, agents and trials for the scaling study (`scaling/`,
scripts/torch_scaling_study.py), the top-agent games (`arena.best`), the
MoHex calibration and the gradient noise scales (`noisescales`). The
fleet (`fleet/`) runs sweeps of `train.run` as jobs on machines' cards,
`backup` mirrors the run store, and `pavlov`'s archive, monitoring and
dashboard keep a run's source and show its stats without pandas.
"""
