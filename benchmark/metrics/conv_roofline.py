"""The convolutions' share of the card's dense peak in the configuration's
precision: the multiply-adds of every convolution a train step runs (the
network's `conv_macs`: the search's evaluations, 2 FLOPs each, and the
learner's forward and backward, 6 a sample) over the device time of
cuDNN's convolution kernels (forward, data gradient, weight gradient) in
the trace. Nothing to read for a network without convolutions or where no
such kernel ran."""
from benchmark import work
from benchmark.reference import nets

# cuDNN's convolution kernels, by name, lower case: the implicit-GEMM
# forward, data and weight gradients (and the weight gradient's workspace
# initialisation), CUTLASS's implicit-GEMM convolutions, and the padding of a
# narrow input's channels; no cuBLAS GEMM's name and no batch norm's holds these
CONV = ("fprop", "dgrad", "wgrad", "convol", "nhwcaddpadding")


def read(ctx):
    cfg = ctx["cell"].config
    conv_macs = getattr(nets.module(cfg), "conv_macs", None)
    t = ctx["trace"].kernel_s(CONV)
    if conv_macs is None or t == 0:
        return None
    flops = conv_macs(cfg) * ctx["n_envs"] * (2 * work.evaluations(cfg) + 6) * ctx["profiled"]
    return 100 * flops / t / work.PEAK_FLOPS[ctx["precision"]]
