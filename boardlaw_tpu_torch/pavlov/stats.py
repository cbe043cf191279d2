"""Stats channels: typed time-series writers with read-time resampling.
Counterpart of boardlaw_tpu/pavlov/stats.py, writing the same files.

Each channel has a *kind* that fixes both what a write records and how a
reader resamples:

    last / max / mean / std_mean / cumsum / rate / timeaverage / duty / silent
    std / period / max_percent / mean_percent / quantiles / line

Writers are no-ops unless inside a `to_run(run)` context; `defer()` batches
writes so the hot loop is not punctuated by file I/O. Rows are appended to
per-channel npr files `stats.<channel>.{n}.npr`; the kind travels in the
file registry. The writers and `channels`/`kind_of`/`rows` use numpy only;
`pandas`, `resampled`, `dataframe` and `review` need pandas.

A value may be a Python or numpy scalar or a torch tensor. Turning a CUDA
tensor into a number waits for the device, so a hot loop should move its
scalars to the host in one transfer first (as `train.run` does).
"""
from __future__ import annotations

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


class Last(Kind):
    name = "last"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).last()


class Max(Kind):
    name = "max"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).max()


class Mean(Kind):
    name = "mean"

    def write(self, channel, total, count=1):
        _emit(self.name, channel, total=total, count=count)

    def resample(self, df, rule):
        r = df.resample(rule).sum()
        return r.total / r["count"]


class StdMean(Kind):
    name = "mean_std"

    def write(self, channel, mu, sigma):
        _emit(self.name, channel, mu=mu, sigma=sigma)

    def resample(self, df, rule):
        r = df.resample(rule).mean()
        return runs.require_pandas().DataFrame({"mu": r.mu, "sigma": r.sigma})


class Cumsum(Kind):
    name = "cumsum"

    def write(self, channel, total=1):
        _emit(self.name, channel, total=total)

    def resample(self, df, rule):
        return df.total.resample(rule).sum().cumsum()


class Rate(Kind):
    name = "rate"

    def write(self, channel, count=1):
        _emit(self.name, channel, count=count)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return df["count"].resample(rule).sum() / secs


class TimeAverage(Kind):
    name = "timeaverage"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).mean()


class Duty(Kind):
    name = "duty"

    def write(self, channel, duration):
        _emit(self.name, channel, duration=duration)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return df.duration.resample(rule).sum() / secs


class Silent(Kind):
    name = "silent"

    def write(self, channel, **fields):
        _emit(self.name, channel, **fields)

    def resample(self, df, rule):
        return df.resample(rule).mean()


class Std(Kind):
    """Standard deviation of the raw values in each window (reference
    kinds.py std)."""

    name = "std"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).std()


class Period(Kind):
    """Average seconds between events (reference kinds.py period — the
    inverse of rate)."""

    name = "period"

    def write(self, channel, count=1):
        _emit(self.name, channel, count=count)

    def resample(self, df, rule):
        secs = runs.require_pandas().Timedelta(rule).total_seconds()
        return secs / df["count"].resample(rule).sum()


class MaxPercent(Kind):
    """Max of a [0,1] fraction, displayed as a percentage (reference
    kinds.py max_percent)."""

    name = "max_percent"
    percent = True

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).max()


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


class Quantiles(Kind):
    """A vector of quantile values per write; each quantile is resampled by
    mean (reference kinds.py quantiles)."""

    name = "quantiles"

    def write(self, channel, xs):
        xs = np.asarray(_to_scalar(xs)).reshape(-1)
        _emit(self.name, channel, **{f"q{i}": float(v) for i, v in enumerate(xs)})

    def resample(self, df, rule):
        return df.resample(rule).mean()


class Line(Kind):
    """Raw line-plot channel: values pass through untouched within each
    window (reference kinds.py line)."""

    name = "line"

    def write(self, channel, x):
        _emit(self.name, channel, x=x)

    def resample(self, df, rule):
        return df.x.resample(rule).mean()


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
