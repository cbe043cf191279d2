"""Device kernels a train step launches, counted in the trace of the
profiled steps: the search driver's glue, the Hex flood's loop and the
kernels together."""


def read(ctx):
    return len(ctx["trace"].kernels()) / ctx["profiled"]
