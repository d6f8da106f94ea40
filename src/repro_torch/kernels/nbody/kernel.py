"""O(N²) gravitational accelerations for Hopper: the wrapper, its launch
count and its plain PyTorch version.

Replaces the Pallas TPU kernel ``nbody`` (body ``_nbody_kernel``) of
``src/repro/kernels/nbody/kernel.py``: for bodies (x, y, z, m),
a_i = Σ_j m_j · d_ij · (|d_ij|² + ε)^{-3/2} with d_ij = p_j − p_i and
ε = 1e-3 added unsquared; the output is (N, 4) with column 3 zero.

The CUDA kernel is ``repro_torch/csrc/nbody.cu``; its header says what
bounds it (fp32 and special-function work on N² pairs) and how a block of
BLOCK_I threads, one a body, streams BLOCK_J bodies at a time through
shared memory.  J_UNROLL is the unroll factor of the inner loop (a
template); KEEP_PAIRWISE is priced by the workload model only.

``nbody`` launches the kernel for CUDA tensors and raises when the build or
the launch fails; it takes ``nbody_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import entry, launch

SOURCE = "nbody.cu"
J_UNROLLS = (1, 2, 4)          # compiled unroll factors
MAX_BLOCK_I = 1024             # threads a block
MAX_BLOCK_J = 2048             # shared-memory body tile: 32 KB
PAIRS_PER_CHUNK = 2**24        # plain version: (rows, N, 3) intermediates
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_nbody_f32", _ARGTYPES)


def _check(bodies: torch.Tensor, block_i: int, block_j: int,
           j_unroll: int) -> None:
    if bodies.dtype != torch.float32:
        raise TypeError(f"nbody takes float32 bodies, got {bodies.dtype}")
    if bodies.dim() != 2 or bodies.shape[1] != 4:
        raise ValueError(f"nbody takes (N, 4) bodies, got "
                         f"{tuple(bodies.shape)}")
    if not bodies.is_contiguous():
        raise ValueError("nbody takes contiguous bodies")
    if not 1 <= block_i <= MAX_BLOCK_I:
        raise ValueError(f"block_i must be in [1, {MAX_BLOCK_I}], got "
                         f"{block_i}")
    if j_unroll not in J_UNROLLS:
        raise ValueError(f"j_unroll must be one of {J_UNROLLS}, got "
                         f"{j_unroll}")
    if not 1 <= block_j <= MAX_BLOCK_J or block_j % j_unroll:
        raise ValueError(f"block_j must be in [1, {MAX_BLOCK_J}] and a "
                         f"multiple of j_unroll, got {block_j}, {j_unroll}")
    if bodies.shape[0] > _INT_MAX:
        raise ValueError("nbody takes fewer than 2**31 bodies")


def nbody_plain(bodies: torch.Tensor, *,
                softening: float = 1e-3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the all-pairs formula over
    chunks of i, so that the (rows, N, 3) intermediates stay within
    ``PAIRS_PER_CHUNK`` pairs (unchunked, N = 131072 would need ~200 GB)."""
    n = bodies.shape[0]
    pos, mass = bodies[:, :3], bodies[:, 3]
    out = torch.zeros((n, 4), dtype=torch.float32, device=bodies.device)
    rows = max(1, PAIRS_PER_CHUNK // max(n, 1))
    for i0 in range(0, n, rows):
        d = pos[None, :, :] - pos[i0:i0 + rows, None, :]   # (rows, N, 3)
        r2 = (d * d).sum(-1) + softening
        inv_r = torch.rsqrt(r2)
        s = mass[None, :] * inv_r * inv_r * inv_r
        out[i0:i0 + rows, :3] = (s[:, :, None] * d).sum(1)
    return out


def nbody(bodies: torch.Tensor, *, block_i: int = 256, block_j: int = 256,
          j_unroll: int = 1, softening: float = 1e-3) -> torch.Tensor:
    """(N, 4) accelerations of ``bodies`` (fp32), column 3 zero, with the
    parameters of the n-body space."""
    _check(bodies, block_i, block_j, j_unroll)
    if bodies.device.type == "cpu":
        return nbody_plain(bodies, softening=softening)
    if bodies.device.type != "cuda":
        raise ValueError(f"nbody runs on CUDA or the CPU, not "
                         f"{bodies.device}")
    if bodies.data_ptr() % 16:
        raise ValueError("nbody reads bodies as float4: their storage must "
                         "be 16-byte aligned")
    n = bodies.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=bodies.device)
    if n == 0:
        return out
    rc = launch(_entry(), bodies.device, bodies.data_ptr(), out.data_ptr(),
                n, block_i, block_j, j_unroll, softening)
    if rc != 0:
        raise RuntimeError(f"nbody kernel launch failed: CUDA error {rc} at "
                           f"N={n} with blocks {(block_i, block_j)}, "
                           f"j_unroll={j_unroll}")
    nbody.launches += 1
    return out


nbody.launches = 0
