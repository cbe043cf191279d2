"""The learner's time a train step: the step less its actor (the push,
reward-to-go, the batch gather, the losses and the Adam step), over the
same timed steps as `actor_ms.train`."""


def read(ctx):
    return (ctx["wrapped_s"] - ctx["actor_s"]) / ctx["timed"] * 1e3
