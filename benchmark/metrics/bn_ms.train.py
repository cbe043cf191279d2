"""Device time of the batch-norm kernels a train step runs (the searches'
eval-mode passes and the learner's train-mode forward and backward), from
the trace: the memory-bound passes that folding batch norm into the
convolutions, or fusing it, would remove."""

# batch norm's kernels, by name: PyTorch's native ones and cuDNN's
BN = ("batch_norm", "batchnorm", "bn_fw", "bn_bw")


def read(ctx):
    return ctx["trace"].kernel_s(BN) / ctx["profiled"] * 1e3
