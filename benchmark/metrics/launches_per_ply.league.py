"""Device kernels a league ply (`ChunkEvaluator.step`) launches, counted
in the trace of the profiled plies."""


def read(ctx):
    return len(ctx["trace"].kernels()) / ctx["profiled"]
