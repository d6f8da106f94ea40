"""Out-of-place fp32 transpose for Hopper: the wrapper, its launch count and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``transpose`` (body ``_transpose_kernel``) of
``src/repro/kernels/transpose/kernel.py``: (M, N) -> (N, M), one
(BLOCK_M, BLOCK_N) tile a program.

The CUDA kernel is ``repro_torch/csrc/transpose.cu``; its header says what
bounds it (reading and writing each byte once) and how a block walks its
TPU-sized tile in 32 x 32 sub-tiles.  BLOCK_M and BLOCK_N set the tile of
one block; STAGE_OUT chooses between staging each sub-tile through padded
shared memory (coalesced writes) and writing direct (strided writes).

``transpose`` launches the kernel for CUDA tensors and raises when the build
or the launch fails; it takes ``transpose_plain`` only for tensors on the
CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import entry, launch

SOURCE = "transpose.cu"
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_transpose_f32", _ARGTYPES)


def _check(x: torch.Tensor, block_m: int, block_n: int, stage_out: int):
    if x.dtype != torch.float32:
        raise TypeError(f"transpose takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"transpose takes a matrix, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("transpose takes a contiguous (row-major) matrix")
    if min(block_m, block_n) < 1:
        raise ValueError(f"block sizes must be positive, got "
                         f"{(block_m, block_n)}")
    if stage_out not in (0, 1):
        raise ValueError(f"stage_out must be 0 or 1, got {stage_out!r}")
    if max(x.shape) > _INT_MAX:
        raise ValueError("transpose dimensions must fit in 32 bits")


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a transposed copy."""
    return x.t().contiguous()


def transpose(x: torch.Tensor, *, block_m: int = 256, block_n: int = 256,
              stage_out: int = 1) -> torch.Tensor:
    """x.T as a new row-major (N, M) matrix, with the parameters of the
    transpose space."""
    _check(x, block_m, block_n, stage_out)
    if x.device.type == "cpu":
        return transpose_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"transpose runs on CUDA or the CPU, not {x.device}")
    m, n = x.shape
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    rc = launch(_entry(), x.device, x.data_ptr(), out.data_ptr(), m, n,
                block_m, block_n, stage_out)
    if rc != 0:
        raise RuntimeError(f"transpose kernel launch failed: CUDA error {rc} "
                           f"at {(m, n)} with blocks {(block_m, block_n)}, "
                           f"stage_out={stage_out}")
    transpose.launches += 1
    return out


transpose.launches = 0
