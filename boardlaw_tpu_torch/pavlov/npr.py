"""Appendable structured-array files ("npr"). Counterpart of
boardlaw_tpu/pavlov/npr.py, byte for byte the same format.

A file is a magic, a one-line JSON header declaring the structured dtype,
then fixed-size packed rows appended and flushed; readers deduce the row
count from the file size, so a reader can tail a file a writer is still
appending to.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

MAGIC = b"NPR1"


def _dtype_from_row(row):
    fields = []
    for k, v in row.items():
        if isinstance(v, (int, np.integer)):
            fields.append((k, "<i8"))
        elif isinstance(v, (float, np.floating)):
            fields.append((k, "<f8"))
        else:
            raise ValueError(f"Unsupported field type for {k}: {type(v)}")
    return np.dtype(fields)


class Writer:
    """Appends dict rows to an npr file; dtype inferred from the first row."""

    def __init__(self, path):
        self.path = Path(path)
        self._file = None
        self.dtype = None

    def _open(self, row):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists() and self.path.stat().st_size > 0:
            with open(self.path, "rb") as f:
                if f.read(4) != MAGIC:
                    raise ValueError(f"{self.path} is not an npr file")
                header = json.loads(f.readline())
            self.dtype = np.dtype([(n, d) for n, d in header["descr"]])
            self._file = open(self.path, "ab")
        else:
            self.dtype = _dtype_from_row(row)
            self._file = open(self.path, "wb")
            self._file.write(MAGIC)
            header = {"descr": [(n, self.dtype[n].str) for n in self.dtype.names]}
            self._file.write((json.dumps(header) + "\n").encode())
            self._file.flush()

    def write(self, row):
        if self._file is None:
            self._open(row)
        arr = np.zeros((), self.dtype)
        for k in self.dtype.names:
            arr[k] = row[k]
        self._file.write(arr.tobytes())
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class Reader:
    """Reads all complete rows currently in an npr file."""

    def __init__(self, path):
        self.path = Path(path)

    def read(self):
        if not self.path.exists():
            return None
        with open(self.path, "rb") as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f"{self.path} is not an npr file")
            header = json.loads(f.readline())
            dtype = np.dtype([(n, d) for n, d in header["descr"]])
            start = f.tell()
            size = os.fstat(f.fileno()).st_size
            n_rows = (size - start) // dtype.itemsize
            return np.frombuffer(f.read(n_rows * dtype.itemsize), dtype)
