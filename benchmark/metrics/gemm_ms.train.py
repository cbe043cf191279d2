"""Device time of the cuBLAS kernels a train step runs (the network's
evaluations and the learner's passes), from the trace."""
from benchmark.trace import GEMM


def read(ctx):
    return ctx["trace"].kernel_s(GEMM) / ctx["profiled"] * 1e3
