"""The port and chip_smoke.py import with JAX, flax, optax and the JAX
package blocked: they import torch and numpy only."""
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "jaxlib", "flax", "optax", "boardlaw_tpu")
        for k in [k for k in sys.modules if k.split(".")[0] in blocked]:
            del sys.modules[k]
        for name in blocked:
            sys.modules[name] = None
        sys.path.insert(0, %r)
        import pkgutil, importlib
        import boardlaw_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(boardlaw_tpu_torch.__path__, "boardlaw_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert "boardlaw_tpu_torch.mcts.kernels" in names
        assert not any(k == "jax" or k.startswith(("jax.", "flax", "optax", "boardlaw_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok", len(names))
    """ % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_in_port_sources():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|boardlaw_tpu)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "boardlaw_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as f:
            assert not banned.search(f.read()), path
