"""The actor's time a train step (`train.actor_record`: the search, the
draw from the root policy and the Hex step), on the host clock with a
synchronize at each end, over the traced run's timed steps."""


def read(ctx):
    return ctx["actor_s"] / ctx["timed"] * 1e3
