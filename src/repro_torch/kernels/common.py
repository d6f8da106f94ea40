"""Shared helpers for the port's kernels: tiling arithmetic and the CUDA
build.

A CUDA source in ``repro_torch/csrc`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The library
goes into ``build/repro_torch/`` at the checkout root, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def lane_efficiency_2d(bm: int, bn: int, m: int, n: int) -> float:
    """Useful-lane fraction for (bm, bn) tiles over an (m, n) problem.

    Carried over formula for formula from the JAX package's workload model:
    padding of the tile to an (8, 128) register tiling, and edge-tile
    padding when the block does not divide the problem.  This is the
    warp-execution-efficiency analog; re-deriving it for the CUDA kernel's
    own staging is queued in ROADMAP.md.
    """
    tile_eff = (bm / round_up(bm, 8)) * (bn / round_up(bn, 128))
    edge_eff = (m / round_up(m, bm)) * (n / round_up(n, bn))
    return tile_eff * edge_eff


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> str:
    """Build ``csrc/<source>`` with ``nvcc`` unless its library is built;
    raise if ``nvcc`` fails.  Returns the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    out = library_path(source)
    log = out.with_suffix(".log")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {CSRC_DIR / source} "
                f"(exit {proc.returncode}):\n{proc.stdout}")
        log.write_text(proc.stdout)
        os.replace(tmp, out)
    return log.read_text() if log.exists() else ""


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    lib = _LOADED.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(str(library_path(source)))
        _LOADED[source] = lib
    return lib
