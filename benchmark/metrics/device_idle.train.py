"""The share of an untraced train step's time in which nothing ran on the
device: 1 less the device's busy time a train step (the union of its activity on
the profiled window's timeline) over the train step's time on the host clock,
untraced. The profiler slows the host (about twice, in a host-bound cell)
but not the device, so the traced window's own wall time would overstate
the idle share."""


def read(ctx):
    busy = ctx["trace"].busy_s / ctx["profiled"]
    return 100 * (1 - busy / (ctx["step_s"] / ctx["timed"]))
