"""Stats channels: typed time-series writers with read-time resampling.
Counterpart of boardlaw_tpu/pavlov/stats.py, writing the same files.

Each channel has a *kind* that fixes both what a write records and how a
reader resamples:

    last / max / mean / std_mean / cumsum / rate / timeaverage / duty / silent
    std / period / max_percent / mean_percent / quantiles / line

Writers are no-ops unless inside a `to_run(run)` context; `defer()` batches
writes so the hot loop is not punctuated by file I/O. Rows are appended to
per-channel npr files `stats.<channel>.{n}.npr`; the kind travels in the
file registry. The writers and `channels`/`kind_of`/`rows` use numpy only,
as does `resampled_arrays`, the numpy resampler equal to `resampled`;
`pandas`, `resampled`, `dataframe` and `review` need pandas.

A value may be a Python or numpy scalar or a torch tensor. Turning a CUDA
tensor into a number waits for the device, so a hot loop should move its
scalars to the host in one transfer first (as `train.run` does).
"""
from __future__ import annotations

import math
import re
from contextlib import contextmanager

import numpy as np
import torch

from . import files, npr, runs, tests

_run = None
_writers = {}
_deferred = None


@contextmanager
def to_run(run):
    """Route subsequent stat writes to `run`."""
    global _run, _writers
    old, old_writers = _run, _writers
    _run, _writers = runs.resolve(run), {}
    try:
        yield
    finally:
        for w in _writers.values():
            w.close()
        _run, _writers = old, old_writers


@contextmanager
def defer():
    """Queue stat writes and flush them on exit (reference deferral.py)."""
    global _deferred
    old = _deferred
    _deferred = []
    try:
        yield
    finally:
        q, _deferred = _deferred, old
        for kind, channel, args, kwargs in q:
            _write(kind, channel, *args, **kwargs)


def _to_scalar(x):
    """Tensors and numpy values as Python scalars (a non-scalar one as a
    numpy array) at write time."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.item() if x.numel() == 1 else x.cpu().numpy()
    if hasattr(x, "item"):
        try:
            return x.item()
        except (ValueError, TypeError):  # a non-scalar array (e.g. quantiles)
            return np.asarray(x)
    return x


def _writer(channel, kind):
    if channel not in _writers:
        existing = files.glob(_run, f"stats.{channel}.{{n}}.npr")
        if existing:
            path = files.path(_run, existing[-1])
        else:
            path = files.new_file(_run, f"stats.{channel}.{{n}}.npr", kind=kind)
        _writers[channel] = npr.Writer(path)
    return _writers[channel]


def _now_us():
    return int(tests.timestamp().timestamp() * 1e6)


def _emit(kind, channel, **fields):
    if _run is None:
        return
    row = {"_time": _now_us()}
    row.update({k: float(_to_scalar(v)) for k, v in fields.items()})
    _writer(channel, kind).write(row)


def _write(kind, channel, *args, **kwargs):
    KINDS[kind].write(channel, *args, **kwargs)


def _dispatch(kind, channel, *args, **kwargs):
    if _run is None:
        return
    if _deferred is not None:
        # materialize scalars now (values may be device arrays from this step)
        args = tuple(_to_scalar(a) for a in args)
        kwargs = {k: _to_scalar(v) for k, v in kwargs.items()}
        _deferred.append((kind, channel, args, kwargs))
    else:
        _write(kind, channel, *args, **kwargs)


class Kind:
    name = None

    def write(self, channel, *args, **kwargs):
        raise NotImplementedError

    def resample(self, df, rule):
        raise NotImplementedError

    def arrays(self, b):
        """`resample` in numpy, on the rows' bins `b` (a `Bins`)."""
        raise NotImplementedError


class Last(Kind):
    name = "last"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).last()

    def arrays(self, b):
        return b.last("x")


class Max(Kind):
    name = "max"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).max()

    def arrays(self, b):
        return b.max("x")


class Mean(Kind):
    name = "mean"

    def write(self, channel, total, count=1):
        _emit(self.name, channel, total=total, count=count)

    def resample(self, df, rule):
        r = df.resample(rule).sum()
        return r.total / r["count"]

    def arrays(self, b):
        return _div(b.sum("total"), b.sum("count"))


class StdMean(Kind):
    name = "mean_std"

    def write(self, channel, mu, sigma):
        _emit(self.name, channel, mu=mu, sigma=sigma)

    def resample(self, df, rule):
        r = df.resample(rule).mean()
        return runs.require_pandas().DataFrame({"mu": r.mu, "sigma": r.sigma})

    def arrays(self, b):
        return {"mu": b.mean("mu"), "sigma": b.mean("sigma")}


class Cumsum(Kind):
    name = "cumsum"

    def write(self, channel, total=1):
        _emit(self.name, channel, total=total)

    def resample(self, df, rule):
        return df.total.resample(rule).sum().cumsum()

    def arrays(self, b):
        return _cumsum(b.sum("total"))


class Rate(Kind):
    name = "rate"

    def write(self, channel, count=1):
        _emit(self.name, channel, count=count)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return df["count"].resample(rule).sum() / secs

    def arrays(self, b):
        return _div(b.sum("count"), b.seconds)


class TimeAverage(Kind):
    name = "timeaverage"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).mean()

    def arrays(self, b):
        return b.mean("x")


class Duty(Kind):
    name = "duty"

    def write(self, channel, duration):
        _emit(self.name, channel, duration=duration)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return df.duration.resample(rule).sum() / secs

    def arrays(self, b):
        return _div(b.sum("duration"), b.seconds)


class Silent(Kind):
    name = "silent"

    def write(self, channel, **fields):
        _emit(self.name, channel, **fields)

    def resample(self, df, rule):
        return df.resample(rule).mean()

    def arrays(self, b):
        return {c: b.mean(c) for c in b.columns}


class Std(Kind):
    """Standard deviation of the raw values in each window (reference
    kinds.py std)."""

    name = "std"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).std()

    def arrays(self, b):
        return b.std("x")


class Period(Kind):
    """Average seconds between events (reference kinds.py period — the
    inverse of rate)."""

    name = "period"

    def write(self, channel, count=1):
        _emit(self.name, channel, count=count)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return secs / df["count"].resample(rule).sum()

    def arrays(self, b):
        return _div(b.seconds, b.sum("count"))


class MaxPercent(Kind):
    """Max of a [0,1] fraction, displayed as a percentage (reference
    kinds.py max_percent)."""

    name = "max_percent"
    percent = True

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).max()

    def arrays(self, b):
        return b.max("x")


class MeanPercent(Kind):
    """Weighted mean of a [0,1] fraction, displayed as a percentage
    (reference kinds.py mean_percent)."""

    name = "mean_percent"
    percent = True

    def write(self, channel, total, count=1):
        _emit(self.name, channel, total=total, count=count)

    def resample(self, df, rule):
        r = df.resample(rule).sum()
        return r.total / r["count"]

    def arrays(self, b):
        return _div(b.sum("total"), b.sum("count"))


class Quantiles(Kind):
    """A vector of quantile values per write; each quantile is resampled by
    mean (reference kinds.py quantiles)."""

    name = "quantiles"

    def write(self, channel, xs):
        xs = np.asarray(_to_scalar(xs)).reshape(-1)
        _emit(self.name, channel, **{f"q{i}": float(v) for i, v in enumerate(xs)})

    def resample(self, df, rule):
        return df.resample(rule).mean()

    def arrays(self, b):
        return {c: b.mean(c) for c in b.columns}


class Line(Kind):
    """Raw line-plot channel: values pass through untouched within each
    window (reference kinds.py line)."""

    name = "line"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).mean()

    def arrays(self, b):
        return b.mean("x")


KINDS = {k.name: k for k in [
    Last(), Max(), Mean(), StdMean(), Cumsum(), Rate(), TimeAverage(), Duty(),
    Silent(), Std(), Period(), MaxPercent(), MeanPercent(), Quantiles(), Line(),
]}


# Public writer API: stats.mean('loss.policy', x), stats.rate('sample-rate', n), ...
def _make(kind):
    def fn(channel, *args, **kwargs):
        _dispatch(kind, channel, *args, **kwargs)

    fn.__name__ = kind
    return fn


last = _make("last")
max = _make("max")  # noqa: A001 - mirrors the reference API
mean = _make("mean")
mean_std = _make("mean_std")
cumsum = _make("cumsum")
rate = _make("rate")
timeaverage = _make("timeaverage")
duty = _make("duty")
silent = _make("silent")
std = _make("std")
period = _make("period")
max_percent = _make("max_percent")
mean_percent = _make("mean_percent")
quantiles = _make("quantiles")
line = _make("line")


# -- readers ----------------------------------------------------------------

def channels(run):
    run = runs.resolve(run)
    names = files.glob(run, "stats.*.{n}.npr")
    return sorted({n.split(".", 1)[1].rsplit(".", 2)[0] for n in names})


def kind_of(run, channel):
    run = runs.resolve(run)
    name = files.glob(run, f"stats.{channel}.{{n}}.npr")[-1]
    return files.info(run, name).get("kind", "silent")


def rows(run, channel):
    """Every row of a channel as one numpy structured array, in time order
    (None when it has none): the reader that needs no pandas."""
    run = runs.resolve(run)
    arrs = [npr.Reader(files.path(run, name)).read()
            for name in files.glob(run, f"stats.{channel}.{{n}}.npr")]
    arrs = [a for a in arrs if a is not None and len(a)]
    if not arrs:
        return None
    out = np.concatenate(arrs)
    return out[np.argsort(out["_time"], kind="stable")]


def pandas(run, channel):
    """Raw rows of a channel as a time-indexed dataframe (needs pandas)."""
    pd = runs.require_pandas()
    arr = rows(run, channel)
    if arr is None:
        return pd.DataFrame()
    df = pd.DataFrame(arr)
    df["_time"] = pd.to_datetime(df["_time"], unit="us")
    return df.set_index("_time")


def resampled(run, channel, rule="60s"):
    """Kind-aware resampling of a channel (needs pandas)."""
    pd = runs.require_pandas()
    df = pandas(run, channel)
    if df.empty:
        return pd.Series(dtype=float)
    return KINDS[kind_of(run, channel)].resample(df, rule)


# -- the numpy resampler: `resampled` without pandas -------------------------

_UNIT_US = {"us": 1, "ms": 10 ** 3, "s": 10 ** 6, "min": 60 * 10 ** 6, "h": 3600 * 10 ** 6}
_DAY_US = 86400 * 10 ** 6


def rule_us(rule):
    """The width of a fixed resampling rule ("60s", "5min", "1h", ...) in
    microseconds; ValueError for any other rule."""
    m = re.fullmatch(r"(\d*)(us|ms|s|min|h)", rule)
    if m is None:
        raise ValueError(f"not a fixed rule of us, ms, s, min or h: {rule!r}")
    return int(m.group(1) or 1) * _UNIT_US[m.group(2)]


class Bins:
    """A channel's rows (time-ordered, as `rows` returns them) in the bins of
    pandas' `resample(rule)` with its defaults: closed on the left, labelled
    by the left edge, the first edge on the rule's grid from midnight of the
    first row's day (`origin="start_day"`), empty bins included. The
    reductions are pandas' groupby ones, in its order of operations, so the
    results are equal to pandas', not only close: compensated sums and
    means, Welford's variance, and NaN values skipped."""

    def __init__(self, arr, rule):
        width = rule_us(rule)
        t = arr["_time"].astype(np.int64)
        first, last = int(t[0]), int(t[-1])
        start = first - first % _DAY_US % width
        n = (last - start) // width + 1
        self.times = start + width * np.arange(n, dtype=np.int64)
        self.seconds = width / 1e6
        self.columns = [c for c in arr.dtype.names if c != "_time"]
        self._which = ((t - start) // width).tolist()
        self._arr = arr

    def _pairs(self, col):
        return zip(self._which, self._arr[col].astype(np.float64).tolist())

    def _out(self, values):
        return np.array(values, dtype=np.float64)

    def sum(self, col):
        """Kahan sums, as pandas' `group_sum` (0 for an empty bin); a sum that
        overflows stays infinite."""
        return self._out(self._kahan(col, math.isfinite)[0])

    def mean(self, col):
        """Kahan sums over the counts, as pandas' `group_mean`."""
        total, nobs = self._kahan(col, lambda c: c == c)
        return self._out([t / k if k else np.nan for t, k in zip(total, nobs)])

    def _kahan(self, col, keep):
        """Per-bin compensated sums and counts of the non-NaN values; a
        compensation that `keep` refuses is reset to 0, as pandas resets
        it (NaN ones in means, every non-finite one in sums)."""
        n = len(self.times)
        total, comp, nobs = [0.0] * n, [0.0] * n, [0] * n
        for b, v in self._pairs(col):
            if v != v:
                continue
            nobs[b] += 1
            y = v - comp[b]
            t = total[b] + y
            c = t - total[b] - y
            comp[b] = c if keep(c) else 0.0
            total[b] = t
        return total, nobs

    def last(self, col):
        out = [np.nan] * len(self.times)
        for b, v in self._pairs(col):
            if v == v:
                out[b] = v
        return self._out(out)

    def max(self, col):
        out, seen = [-np.inf] * len(self.times), [False] * len(self.times)
        for b, v in self._pairs(col):
            if v == v:
                seen[b] = True
                if v > out[b]:
                    out[b] = v
        return self._out([m if k else np.nan for m, k in zip(out, seen)])

    def std(self, col):
        """Welford's update, as pandas' `group_var`; ddof 1."""
        n = len(self.times)
        mean, m2, nobs = [0.0] * n, [0.0] * n, [0] * n
        for b, v in self._pairs(col):
            if v != v:
                continue
            nobs[b] += 1
            old = mean[b]
            mean[b] += (v - old) / nobs[b]
            m2[b] += (v - mean[b]) * (v - old)
        var = self._out([m / (k - 1) if k > 1 else np.nan for m, k in zip(m2, nobs)])
        with np.errstate(invalid="ignore"):  # a negative one (from infinities) is NaN
            return np.sqrt(var)


def _div(a, b):
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.true_divide(a, b)


def _cumsum(x):
    """pandas' `cumsum`: NaN entries stay NaN and add nothing."""
    nan = np.isnan(x)
    out = np.cumsum(np.where(nan, 0.0, x))
    out[nan] = np.nan
    return out


def resample_rows(kind, arr, rule="60s"):
    """Rows (`rows`' structured array) of a channel of `kind`, resampled by
    the kind's rule in numpy: `(times, values)`, the bins' left edges in
    microseconds since the epoch and the values, one array or (for the
    kinds that give pandas a DataFrame) a dict of arrays by column."""
    if arr is None or not len(arr):
        return np.zeros(0, np.int64), np.zeros(0)
    b = Bins(arr, rule)
    return b.times, KINDS[kind].arrays(b)


def resampled_arrays(run, channel, rule="60s"):
    """`resampled` in numpy, equal to it, for machines without pandas:
    `resample_rows` of the channel's rows."""
    run = runs.resolve(run)
    return resample_rows(kind_of(run, channel), rows(run, channel), rule)


def dropna(times, values):
    """`resampled_arrays`' result without the bins where any column is NaN,
    as pandas' `dropna` (infinities stay)."""
    cols = values.values() if isinstance(values, dict) else [values]
    keep = ~np.any([np.isnan(c) for c in cols], axis=0)
    if isinstance(values, dict):
        return times[keep], {k: v[keep] for k, v in values.items()}
    return times[keep], values[keep]


def dataframe(run, rule="60s", channels_=None):
    """Wide analysis frame: every channel resampled on a shared time index,
    multi-column kinds flattened with dotted suffixes (needs pandas)."""
    pd = runs.require_pandas()
    run = runs.resolve(run)
    cols = {}
    for c in channels_ or channels(run):
        try:
            r = resampled(run, c, rule)
        except Exception:
            continue
        if isinstance(r, pd.DataFrame):
            for sub in r.columns:
                cols[f"{c}.{sub}"] = r[sub]
        else:
            cols[c] = r
    if not cols:
        return pd.DataFrame()
    return pd.DataFrame(cols)


def review(run, rule="60s"):
    """One-line-per-channel text summary of the latest resampled values
    (needs pandas)."""
    pd = runs.require_pandas()
    lines = []
    for c in channels(run):
        try:
            r = resampled(run, c, rule)
            tail = r.dropna().iloc[-1] if len(r.dropna()) else float("nan")
            if isinstance(tail, pd.Series):
                tail = " ".join(f"{k}={v:.4g}" for k, v in tail.items())
            else:
                tail = f"{tail:.6g}"
            lines.append(f"{c:<30} {tail}")
        except Exception as e:  # reading while writing shouldn't crash a monitor
            lines.append(f"{c:<30} <error: {e}>")
    return "\n".join(lines)
