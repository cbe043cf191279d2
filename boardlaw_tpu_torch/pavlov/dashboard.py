"""Self-contained live HTML dashboard for a run. Counterpart of
boardlaw_tpu/pavlov/dashboard.py, rendering the same page.

`render` builds one standalone HTML page (inline SVG sparklines, small
multiples: one series per chart, grouped by channel prefix, plus a log
tail), `write` drops it in the run dir, and `serve` exposes it over HTTP,
re-rendering on every request. The channels are read through
`stats.resampled_arrays`, the numpy resampler, so the page has its charts
on a machine without pandas.
"""
from __future__ import annotations

import html
import math
import os
import tempfile
import threading

from . import files, logs, runs, stats

ACCENT = "#1d4ed8"  # single accent hue; text/grid stay neutral ink
INK = "#111827"
MUTED = "#6b7280"
GRID = "#e5e7eb"
BAND = "rgba(29,78,216,0.15)"

_CSS = f"""
body {{ font: 13px/1.4 system-ui, sans-serif; color: {INK}; margin: 16px;
       background: #ffffff; }}
h1 {{ font-size: 16px; margin: 0 0 2px; }}
h2 {{ font-size: 13px; color: {MUTED}; font-weight: 600;
     margin: 18px 0 6px; border-bottom: 1px solid {GRID}; }}
.meta {{ color: {MUTED}; margin-bottom: 10px; }}
.grid {{ display: flex; flex-wrap: wrap; gap: 12px; }}
.card {{ border: 1px solid {GRID}; border-radius: 6px; padding: 8px 10px;
        width: 240px; }}
.card .name {{ color: {MUTED}; font-size: 11px; overflow: hidden;
              text-overflow: ellipsis; white-space: nowrap; }}
.card .val {{ font-size: 18px; font-weight: 600; font-variant-numeric:
             tabular-nums; }}
svg {{ display: block; margin-top: 4px; }}
pre {{ background: #f9fafb; border: 1px solid {GRID}; border-radius: 6px;
      padding: 8px; font-size: 11px; overflow-x: auto; }}
"""


def _fmt(v):
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "—"
    a = abs(v)
    if a >= 1e5 or (a > 0 and a < 1e-3):
        return f"{v:.3g}"
    return f"{v:,.4g}"


def _spark(xs, lo=None, hi=None, band=None, w=220, h=48):
    """Inline-SVG sparkline: 2px accent line, recessive baseline, native
    <title> tooltips on hover columns; optional ±band (mean_std channels)."""
    xs = [float(x) for x in xs]
    n = len(xs)
    if n == 0:
        return ""
    finite = [x for x in xs if math.isfinite(x)]
    if not finite:
        return ""
    lo = min(finite) if lo is None else lo
    hi = max(finite) if hi is None else hi
    if band is not None:
        bl = [x - s for x, s in zip(xs, band) if math.isfinite(x - s)]
        bh = [x + s for x, s in zip(xs, band) if math.isfinite(x + s)]
        lo, hi = min([lo] + bl), max([hi] + bh)
    span = (hi - lo) or 1.0
    px = lambda i: 2 + i * (w - 4) / max(n - 1, 1)
    py = lambda x: 2 + (h - 4) * (1 - (x - lo) / span)
    pts = " ".join(
        f"{px(i):.1f},{py(x):.1f}" for i, x in enumerate(xs) if math.isfinite(x))
    parts = [f'<svg width="{w}" height="{h}" role="img">']
    if band is not None:
        up = [(px(i), py(x + s)) for i, (x, s) in enumerate(zip(xs, band))
              if math.isfinite(x + s)]
        dn = [(px(i), py(x - s)) for i, (x, s) in enumerate(zip(xs, band))
              if math.isfinite(x - s)]
        poly = " ".join(f"{a:.1f},{b:.1f}" for a, b in up + dn[::-1])
        parts.append(f'<polygon points="{poly}" fill="{BAND}" stroke="none"/>')
    parts.append(f'<line x1="2" y1="{h-2}" x2="{w-2}" y2="{h-2}" '
                 f'stroke="{GRID}" stroke-width="1"/>')
    parts.append(f'<polyline points="{pts}" fill="none" stroke="{ACCENT}" '
                 f'stroke-width="2" stroke-linejoin="round"/>')
    # hover targets: one column per point, native tooltip with the value
    colw = (w - 4) / max(n - 1, 1)
    for i, x in enumerate(xs):
        if math.isfinite(x):
            parts.append(
                f'<rect x="{px(i)-colw/2:.1f}" y="0" width="{colw:.1f}" '
                f'height="{h}" fill="transparent"><title>{_fmt(x)}</title></rect>')
    parts.append("</svg>")
    return "".join(parts)


def _series_of(run, channel, rule):
    """Channel -> list of (label, values, band|None); one chart per column so
    every chart stays single-series (no legend needed)."""
    try:
        times, r = stats.dropna(*stats.resampled_arrays(run, channel, rule))
    except ImportError:  # a missing library is not a malformed channel
        raise
    except Exception:
        return []
    if len(times) == 0:
        return []
    if isinstance(r, dict):  # the kinds of several columns
        if set(r) >= {"mu", "sigma"}:  # mean_std: line + ±σ band
            return [(channel, r["mu"].tolist(), r["sigma"].tolist())]
        return [(f"{channel} ({c})", v.tolist(), None) for c, v in r.items()]
    return [(channel, r.tolist(), None)]


def render(run, rule="60s", refresh=10, points=120, log_lines=15):
    """One standalone HTML page of the run's stats + log tail."""
    run = runs.resolve(run)
    groups: dict[str, list] = {}
    for c in stats.channels(run):
        head = c.split(".", 1)[0]
        groups.setdefault(head, []).append(c)

    body = [f"<h1>{html.escape(run)}</h1>",
            f'<div class="meta">rule={rule} · refreshes every {refresh}s</div>']
    for head in sorted(groups):
        cards = []
        for channel in sorted(groups[head]):
            for label, vals, band in _series_of(run, channel, rule):
                vals = vals[-points:]
                band = band[-points:] if band is not None else None
                last = next((v for v in reversed(vals) if math.isfinite(v)), None)
                cards.append(
                    '<div class="card">'
                    f'<div class="name" title="{html.escape(label)}">'
                    f'{html.escape(label)}</div>'
                    f'<div class="val">{_fmt(last)}</div>'
                    f"{_spark(vals, band=band)}</div>")
        if cards:
            body.append(f"<h2>{html.escape(head)}</h2>"
                        f'<div class="grid">{"".join(cards)}</div>')

    try:
        tail = logs.tail(run, log_lines)
    except Exception:
        tail = ""
    if tail:
        body.append(f"<h2>logs</h2><pre>{html.escape(tail)}</pre>")

    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<meta http-equiv='refresh' content='{refresh}'>"
            f"<title>{html.escape(run)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>")


def write(run, path=None, **kwargs):
    """Render into the run dir (registered, atomic tmp+rename like every
    pavlov artifact) or to an explicit path."""
    page = render(run, **kwargs)
    if path is None:
        path = files.new_file(runs.resolve(run), "dashboard.html")
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(str(path)))
    with os.fdopen(fd, "w") as f:
        f.write(page)
    os.replace(tmp, path)
    return path


def serve(run, port=0, **kwargs):
    """Serve the dashboard over HTTP, re-rendering per request (the live
    analogue of the reference's Bokeh server). Returns the HTTPServer; its
    .server_address[1] is the bound port; call .shutdown() to stop."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API
            try:
                page = render(run, **kwargs).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
            except Exception as e:
                page = f"render failed: {e}".encode()
                self.send_response(500)
                self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
