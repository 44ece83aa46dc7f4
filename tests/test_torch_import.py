"""The port stands alone: no JAX, no module of the JAX package.

* In a fresh interpreter where ``jax`` and ``repro`` cannot be imported,
  ``repro_torch`` and every submodule import.
* An AST scan of ``src/repro_torch/`` and of ``chip_smoke.py`` finds no
  import of ``jax`` (or ``jaxlib``) and none of ``repro``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import pkgutil, importlib
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print(len(mods))
"""


def test_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _banned(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("target", ["src/repro_torch", "chip_smoke.py"])
def test_no_jax_or_repro_imports(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _banned(name)]
    assert not bad, bad
