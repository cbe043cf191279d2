"""Run-archive sync: mirror the run store to and from a backup target.
Counterpart of boardlaw_tpu/backup.py.

The target is any rsync-able destination (a mounted bucket, an NFS path, or
`user@host:path`); where the system has no `rsync`, a local target is
copied with `shutil.copytree`. `backup` mirrors the whole run store one way,
`fetch` mirrors it back, `fetch_run` brings one run.
"""
from __future__ import annotations

import shutil
import subprocess
from logging import getLogger
from pathlib import Path

from .pavlov import runs

log = getLogger(__name__)


def _rsync(src, dst, delete=False):
    if shutil.which("rsync") is None:
        # local-path fallback when no rsync binary exists
        src_dir = Path(str(src).rstrip("/"))
        dst_dir = Path(str(dst).rstrip("/"))
        if delete and dst_dir.exists():
            shutil.rmtree(dst_dir)
        shutil.copytree(src_dir, dst_dir, dirs_exist_ok=True)
        return
    cmd = ["rsync", "-az"] + (["--delete"] if delete else []) + [str(src), str(dst)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"rsync failed: {r.stderr.strip()}")


def backup(target, delete=False):
    """Mirror the whole run store to the target."""
    src = runs.root()
    _rsync(f"{src}/", f"{target}/", delete=delete)
    log.info(f"backed up {src} -> {target}")


def fetch(target):
    """Mirror the target back into the local run store."""
    dst = runs.root()
    _rsync(f"{target}/", f"{dst}/", delete=False)
    log.info(f"fetched {target} -> {dst}")


def fetch_run(target, run):
    """Fetch one run directory."""
    dst = runs.root() / run
    dst.mkdir(parents=True, exist_ok=True)
    _rsync(f"{Path(target) / run}/", f"{dst}/")
    return dst
