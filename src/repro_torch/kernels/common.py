"""Shared helpers for the port's kernels: tiling arithmetic, the card's SM
count and the CUDA build.

A CUDA source in ``repro_torch/csrc`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The library
goes into ``build/repro_torch/`` at the checkout root, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is not.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CPU_SMS = 132                  # the H100 SXM's SMs: the splits the CPU sees

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


@functools.cache
def _cuda_sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of the card ``device`` (a ``torch.device``) lies on; on the
    CPU those of the H100 SXM, so that a plain version splits its work as
    the kernel would there."""
    if device.type != "cuda":
        return CPU_SMS
    import torch

    return _cuda_sms(device.index if device.index is not None
                     else torch.cuda.current_device())


def nvcc() -> str:
    """The path of ``nvcc``: on PATH, else under CUDA_HOME, CUDA_PATH or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


@functools.cache
def _sass(library: Path) -> str:
    tool = Path(nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(library)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {library} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def count_sass(source: str, opcode: str, function: str = "") -> int:
    """How many instructions of ``opcode`` (e.g. ``HMMA``, a tensor-core
    product; ``MUFU.RSQ``) the built library of ``csrc/<source>`` holds,
    in the kernels whose (mangled) name contains ``function``, from
    ``cuobjdump -sass``; raises if the tool fails."""
    count, inside = 0, not function
    for line in _sass(library_path(source)).splitlines():
        if "Function : " in line:
            inside = function in line
        elif inside and (f" {opcode}" in line or f"\t{opcode}" in line):
            count += 1
    return count


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a
    hash of the source, every shared header ``csrc/*.cuh`` (any of them may
    be included) and the flags."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
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
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
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


def entry(source: str, symbol: str, argtypes) -> Callable[..., int]:
    """The plain C entry ``symbol`` of ``csrc/<source>``, returning a
    ``cudaError_t`` as int.  Pointers and the stream go as ``c_void_p``:
    ctypes would pass a bare Python int as a 32-bit int and cut it."""
    fn = getattr(load_library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn: Callable[..., int], device, *args) -> int:
    """Call the C entry ``fn`` with ``args`` and then the current stream of
    CUDA ``device``; returns its ``cudaError_t``."""
    import torch

    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
