"""Build and locate the bundled `gtphex` GTP engine. Counterpart of
boardlaw_tpu/gtp_engine.py.

The engine's source is the port's own copy of the JAX package's C++ file,
`boardlaw_tpu_torch/cpp/gtphex.cpp` (kept byte for byte equal to it),
compiled with g++ into a content-hashed file under the port's ignored
`_build/` directory (or `GTPHEX_CACHE`). It picks immediate wins and otherwise maximises the
win rate of uniform playouts; `mohex.MoHexAgent(command=command())` plays
it through the full load-SGF / reg_genmove round trip, the stand-in for
MoHex where no MoHex binary exists.
"""
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "cpp" / "gtphex.cpp"
CACHE = Path(os.environ.get("GTPHEX_CACHE", Path(__file__).resolve().parent / "_build"))


def available():
    """True if a C++ compiler is present to build the engine."""
    return shutil.which("g++") is not None


def binary():
    """Compile (once, content-hashed) and return the engine's path."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = CACHE / f"gtphex-{tag}"
    if out.exists():
        return str(out)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".build{os.getpid()}")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return str(out)


def command(seed=0x5EED, playouts=None):
    """A command line for mohex.GTP/MoHex(command=...). `playouts` is
    accepted as in the JAX package, which does not pass it on either."""
    return f"{binary()} --seed={int(seed)}"
