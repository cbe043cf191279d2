"""`node_actions`'s share of its roofline: the least time the bytes of the
K=1 search's calls need (each simulation's live rows, `work.search_bytes`)
over the kernel's device time in the trace. Nothing to read where the
search does not run that kernel."""
from benchmark import work


def read(ctx):
    cfg = ctx["cell"].config
    t = ctx["trace"].kernel_s(("node_actions_kernel",))
    if cfg["leaves_per_pass"] != 1 or t == 0:
        return None
    return 100 * work.search_bytes(cfg, ctx["n_envs"]) * ctx["profiled"] / work.HBM_BYTES_PER_S / t
