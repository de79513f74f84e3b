"""Build the CUDA sources of ``repro_torch/csrc`` and load them with ctypes.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands
in ``repro_torch/_build/`` (listed in ``.gitignore``) under a name that
hashes the source, the headers beside it (``*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<name>.cu`` (by default this package's ``csrc``)
    unless a library for this exact source and these flags exists; return
    the library's path. ``ptxas``'s register and shared-memory report is
    kept beside it as ``<lib>.log``."""
    src = Path(csrc) / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(Path(csrc).glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr[-8000:]}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)           # atomic: a concurrent build loses nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
