"""Results database: runs, snapshots, agents, trials, MoHex trials and noise
scales in SQLite. Counterpart of boardlaw_tpu/sql.py, with its schema, its
`agents_details` view and its `BOARDLAW_DB` default, so either package reads
the other's database.

`refresh` walks the port's pavlov registry (which reads the JAX package's
runs too) and registers every run, snapshot and default test-search agent.
The queries return `Rows`: numpy columns as attributes, what the card's
machine, which has no pandas, reads; `Rows.frame()` gives the JAX package's
DataFrame where pandas is present.
"""
from __future__ import annotations

import os
import sqlite3
from contextlib import contextmanager
from logging import getLogger
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .pavlov import runs, storage as pstorage

log = getLogger(__name__)

SCHEMA = """
create table if not exists runs (
    run text primary key,
    description text,
    boardsize integer,
    width integer,
    depth integer,
    nodes integer);

create table if not exists snaps (
    id integer primary key autoincrement,
    run text references runs(run),
    idx integer,
    samples real,
    flops real,
    unique(run, idx));

create table if not exists agents (
    id integer primary key autoincrement,
    snap integer references snaps(id),
    nodes integer,
    c real,
    unique(snap, nodes, c));

create table if not exists trials (
    id integer primary key autoincrement,
    black_agent integer references agents(id),
    white_agent integer references agents(id),
    black_wins integer,
    white_wins integer,
    moves integer,
    times real);

create table if not exists mohex_trials (
    id integer primary key autoincrement,
    black_agent integer,
    white_agent integer,
    black_wins integer,
    white_wins integer,
    moves integer,
    times real);

create table if not exists noise_scales (
    id integer primary key autoincrement,
    agent_id integer references agents(id),
    kind text,
    mean_sq real,
    sq_mean real,
    variance real,
    n_params real,
    batch_size real,
    batches real);
"""

VIEW = """
create view if not exists agents_details as
select
    agents.id, agents.nodes as test_nodes, agents.c as test_c,
    snaps.id as snap_id, snaps.samples, snaps.flops as train_flops, snaps.idx,
    runs.run, runs.description, runs.boardsize, runs.width, runs.depth,
    runs.nodes as train_nodes
from agents
    inner join snaps on (agents.snap == snaps.id)
    inner join runs on (snaps.run == runs.run)
"""


def _column(values):
    """A column's values as numpy, typed as pandas types a query's column:
    int64 where every value is an int, float64 where the values are numbers
    (None as NaN), else an object array."""
    if all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        return np.array(values, dtype=np.int64)
    if all(v is None or isinstance(v, (int, float)) for v in values):
        return np.array([np.nan if v is None else v for v in values], dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


class Rows:
    """A query's rows as numpy columns, each an attribute named as the
    column, with the index column's values as `index` (positions where
    there is none). `len()`, `row(key)` (one row by its index value, a
    namespace of Python scalars), `take(positions)` (a slice, positions or
    a boolean mask) and `frame()`, the JAX package's DataFrame (needs
    pandas)."""

    def __init__(self, columns, rows=(), index_col=None):
        self.columns = list(columns)
        self.index_col = index_col
        self._rows = [tuple(r) for r in rows]
        for i, c in enumerate(self.columns):
            setattr(self, c, _column([r[i] for r in self._rows]))
        self.index = getattr(self, index_col) if index_col else np.arange(len(self._rows))

    def __len__(self):
        return len(self._rows)

    def __iter__(self):
        """The rows as namespaces, in order."""
        for r in self._rows:
            yield SimpleNamespace(**dict(zip(self.columns, r)))

    def row(self, key):
        hits = np.flatnonzero(self.index == key)
        if len(hits) == 0:
            raise KeyError(key)
        return SimpleNamespace(**dict(zip(self.columns, self._rows[hits[0]])))

    def take(self, positions):
        picked = np.arange(len(self._rows))[positions]
        return Rows(self.columns, [self._rows[i] for i in picked], self.index_col)

    def frame(self):
        pd = runs.require_pandas()
        df = pd.DataFrame.from_records(self._rows, columns=self.columns, coerce_float=True)
        return df.set_index(self.index_col) if self.index_col else df


def database_path():
    return Path(os.environ.get("BOARDLAW_DB", "output/experiments/eval/database.sql"))


@contextmanager
def connection():
    p = database_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    conn = sqlite3.connect(p)
    try:
        conn.executescript(SCHEMA)
        conn.execute(VIEW)
        yield conn
        conn.commit()
    finally:
        conn.close()


def _select(conn, q, args=(), index_col=None):
    cur = conn.execute(q, tuple(args))
    return Rows([d[0] for d in cur.description], cur.fetchall(), index_col)


def query(q, *args):
    """Parameterised select -> `Rows`."""
    with connection() as conn:
        return _select(conn, q, args)


def execute(q, *args):
    """Parameterised write."""
    with connection() as conn:
        conn.execute(q, args)


# -- ingestion --------------------------------------------------------------

def refresh():
    """Register every pavlov run, its snapshots, and a default test-search
    agent per snapshot (the run's nodes and c_puct)."""
    with connection() as conn:
        for run in runs.list_runs():
            info = runs.info(run)
            params = info.get("params", {})
            if "boardsize" not in params:
                continue
            conn.execute(
                "insert or ignore into runs (run, description, boardsize, width, depth, nodes)"
                " values (?,?,?,?,?,?)",
                (run, info.get("description", ""), params.get("boardsize"), params.get("width"),
                 params.get("depth"), params.get("nodes", 64)),
            )
            for idx in pstorage.snapshots(run):
                meta = pstorage.snapshot_info(run, idx)
                conn.execute(
                    "insert or ignore into snaps (run, idx, samples, flops) values (?,?,?,?)",
                    (run, idx, meta.get("n_samples"), meta.get("n_flops")),
                )
                snap_id = conn.execute(
                    "select id from snaps where run=? and idx=?", (run, idx)).fetchone()[0]
                conn.execute(
                    "insert or ignore into agents (snap, nodes, c) values (?,?,?)",
                    (snap_id, params.get("nodes", 64), params.get("c_puct", 1 / 16)),
                )


# -- queries ----------------------------------------------------------------

def agent_query():
    """`agents_details`, indexed by agent id."""
    with connection() as conn:
        return _select(conn, "select * from agents_details", index_col="id")


def trial_query(boardsize=None, desc=None):
    """Trials with the black agent's boardsize and description, indexed by
    trial id."""
    q = """
        select trials.*, b.boardsize as boardsize, b.description as description
        from trials
        inner join agents_details b on (trials.black_agent == b.id)
    """
    clauses, args = [], []
    if boardsize is not None:
        clauses.append("b.boardsize = ?")
        args.append(boardsize)
    if desc is not None:
        clauses.append("b.description like ?")
        args.append(desc)
    if clauses:
        q += " where " + " and ".join(clauses)
    with connection() as conn:
        return _select(conn, q, args, index_col="id")


def trial_matrices(trials):
    """`elos.symmetric_matrices` of trials over their agent ids in numeric
    order (the JAX package's frames are indexed so): (wins, games, ids)."""
    from . import elos

    ids = sorted({int(a) for a in trials.black_agent} | {int(a) for a in trials.white_agent})
    ws, gs, _ = elos.symmetric_matrices(trials, [str(i) for i in ids])
    return ws, gs, ids


def save_trials(rows):
    """Persist trial outcomes: iterable of (black_agent, white_agent,
    black_wins, white_wins, moves, times)."""
    with connection() as conn:
        conn.executemany(
            "insert into trials (black_agent, white_agent, black_wins, white_wins, moves, times)"
            " values (?,?,?,?,?,?)",
            list(rows),
        )


def save_mohex_trials(rows):
    with connection() as conn:
        conn.executemany(
            "insert into mohex_trials (black_agent, white_agent, black_wins, white_wins, moves,"
            " times) values (?,?,?,?,?,?)",
            list(rows),
        )


def save_noise_scale(agent_id, kind, **fields):
    with connection() as conn:
        conn.execute(
            "insert into noise_scales (agent_id, kind, mean_sq, sq_mean, variance, n_params,"
            " batch_size, batches) values (?,?,?,?,?,?,?,?)",
            (agent_id, kind, fields.get("mean_sq"), fields.get("sq_mean"), fields.get("variance"),
             fields.get("n_params"), fields.get("batch_size"), fields.get("batches")),
        )


def mohex_trial_query():
    with connection() as conn:
        return _select(conn, "select * from mohex_trials", index_col="id")
