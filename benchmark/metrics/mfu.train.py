"""The whole train step's share of the card's peak in the configuration's
precision: the model FLOPs a step needs (`work.train_step_flops`: 2 FLOPs
a multiply-add for each evaluation of the search, 6 for each learner
sample) over the step's time on the host clock, untraced."""
from benchmark import work


def read(ctx):
    flops = work.train_step_flops(ctx["cell"].config) * ctx["timed"]
    return 100 * flops / ctx["step_s"] / work.PEAK_FLOPS[ctx["precision"]]
