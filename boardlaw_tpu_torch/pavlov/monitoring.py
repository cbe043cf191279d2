"""Live run monitors: a terminal tree view and matplotlib charts.
Counterpart of boardlaw_tpu/pavlov/monitoring.py, giving the same text.

The channels are read through `stats.resampled_arrays`, the numpy
resampler, so `tree_view` and `monitor` run without pandas; `plot` imports
matplotlib where it is called.
"""
from __future__ import annotations

import time

from . import logs, stats


def _latest(run, channel, rule):
    """The channel's last resampled bin without NaN, as the JAX tree view
    prints it: `k=v` pairs for the kinds of several columns."""
    times, r = stats.dropna(*stats.resampled_arrays(run, channel, rule))
    if not len(times):
        return "nan"
    if isinstance(r, dict):
        return " ".join(f"{k}={v[-1]:.4g}" for k, v in r.items())
    return f"{r[-1]:.6g}"


def tree_view(run, rule="60s"):
    """Stats grouped by dotted prefix into an indented tree."""
    lines = []
    groups = {}
    for c in stats.channels(run):
        head, _, tail = c.partition(".")
        groups.setdefault(head, []).append((tail or head, c))
    for head in sorted(groups):
        lines.append(head)
        for tail, channel in sorted(groups[head]):
            try:
                val = _latest(run, channel, rule)
            except ImportError:
                raise
            except Exception as e:  # a malformed channel must not stop the monitor
                val = f"<{e}>"
            lines.append(f"  {tail:<28} {val}")
    return "\n".join(lines)


def monitor(run, rule="60s", interval=10, iterations=None):
    """Refreshing terminal monitor: the stats tree and the log's tail."""
    i = 0
    while iterations is None or i < iterations:
        print("\x1b[2J\x1b[H", end="")  # clear screen
        print(tree_view(run, rule))
        print("\n--- logs ---")
        print(logs.tail(run, 8))
        time.sleep(interval)
        i += 1


def plot(run, channels=None, rule="60s"):
    """Matplotlib grid of the resampled channels, one chart a channel (a line
    a column)."""
    import matplotlib.pyplot as plt

    channels = channels or stats.channels(run)
    n = len(channels)
    if n == 0:
        return None
    cols = min(3, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.5 * rows), squeeze=False)
    for ax, c in zip(axes.flat, channels):
        try:
            times, r = stats.dropna(*stats.resampled_arrays(run, c, rule))
            x = times.astype("datetime64[us]")
            for label, v in (r.items() if isinstance(r, dict) else [(c, r)]):
                ax.plot(x, v, label=label)
            if isinstance(r, dict):
                ax.legend(fontsize=6)
        except ImportError:
            raise
        except Exception:  # a malformed channel leaves its chart empty
            pass
        ax.set_title(c, fontsize=8)
        ax.grid(alpha=0.25)
    for ax in axes.flat[n:]:
        ax.axis("off")
    fig.tight_layout()
    return fig
