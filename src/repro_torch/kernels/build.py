"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``repro_torch/csrc/`` with a plain
C interface, compiled by ``nvcc`` for ``sm_90a`` into a shared library
and bound with ``ctypes``.  Libraries land in ``build/repro_torch/`` at
the root of the checkout, named by a hash of their source and of every
header it includes from ``csrc/`` (``#include "..."``, followed through
headers), so an edited kernel or header is never served from a stale
build.  Nothing is built at import: the first launch (or ``build()``)
compiles, and several kernels compile in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: library name -> source file under csrc/ (``pack4.cu`` holds both the
#: pack and the unpack kernel, ``lif_encode.cu`` the encoder and its
#: backward)
SOURCES = {"paged_decode": "paged_decode.cu", "lif_encode": "lif_encode.cu",
           "count_matmul": "count_matmul.cu", "pack4": "pack4.cu",
           "roundtrip_bwd": "roundtrip_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def build_dir() -> Path:
    """``build/repro_torch/`` at the root of the checkout (``src/..``)."""
    return _PKG.parent.parent / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def source_files(src: Path) -> list:
    """``src`` and every file it includes with ``#include "..."`` that
    exists beside the includer, followed through includes, each once, in
    the order first reached."""
    files = []

    def walk(path: Path):
        if path in files:
            return
        files.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep.is_file():
                walk(dep)

    walk(Path(src).resolve())
    return files


def source_digest(src: Path) -> str:
    """12 hex digits of a hash over ``source_files(src)``: names and
    contents."""
    h = hashlib.sha256()
    for path in source_files(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    digest = source_digest(CSRC / SOURCES[name])
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every named kernel not built yet, all ``nvcc`` processes
    started together.  Returns ``{name: compiler output}`` (ptxas
    register/shared-memory report); raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
