"""Tiled fp32 GEMM for Hopper: the wrapper, its launch count and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``matmul`` (body ``_matmul_kernel``) of
``src/repro/kernels/matmul/kernel.py``: C = A·B in fp32 with an fp32
accumulator swept over K in BLOCK_K steps, the K tail masked, and
``loop_order`` choosing the raster of output tiles.

The CUDA kernel is ``repro_torch/csrc/matmul.cu``; its header says what
bounds it on the H100 (fp32 pipes at 2048³, reading B for skinny
products) and how it covers TPU-sized tiles with 64 x 64 sub-tiles staged
through shared memory.  In it BLOCK_M, BLOCK_N and LOOP_ORDER change the
code path, BLOCK_K only the K sweep step; ACC_F32 is ignored, as the Pallas
kernel ignores it.

``matmul`` launches the kernel for CUDA tensors and raises when the build
or the launch fails; it takes ``matmul_plain`` only for tensors on the CPU
(the analogue of Pallas interpret mode, for the tests).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import cdiv, entry, launch

SOURCE = "matmul.cu"
_LOOP_ORDERS = {"mnk": 0, "nmk": 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_matmul_f32", _ARGTYPES)


def _check(a: torch.Tensor, b: torch.Tensor, block_m: int, block_n: int,
           block_k: int, loop_order: str) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul takes float32, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes do not chain: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous (row-major) operands")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"block sizes must be positive, got "
                         f"{(block_m, block_n, block_k)}")
    if loop_order not in _LOOP_ORDERS:
        raise ValueError(f"loop_order must be 'mnk' or 'nmk', got "
                         f"{loop_order!r}")
    if max(*a.shape, b.shape[1]) > _INT_MAX:
        raise ValueError("matmul dimensions must fit in 32 bits")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
                 block_n: int = 128, block_k: int = 128,
                 loop_order: str = "mnk") -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: output tiles in the
    kernel's raster, each an fp32 sum over BLOCK_K steps of K.  Slicing
    past an edge stops at it, which masks the ragged M, N and K tails."""
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    tiles = [(i, j) for i in range(cdiv(m, block_m))
             for j in range(cdiv(n, block_n))]
    if loop_order == "nmk":
        tiles.sort(key=lambda t: (t[1], t[0]))
    for i, j in tiles:
        rows = slice(i * block_m, (i + 1) * block_m)
        cols = slice(j * block_n, (j + 1) * block_n)
        acc = torch.zeros_like(c[rows, cols])
        for k0 in range(0, k, block_k):
            ks = slice(k0, k0 + block_k)
            acc += a[rows, ks] @ b[ks, cols]
        c[rows, cols] = acc
    return c


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128,
           loop_order: str = "mnk") -> torch.Tensor:
    """C = A @ B (fp32) with the tuning parameters of the GEMM space."""
    _check(a, b, block_m, block_n, block_k, loop_order)
    if a.device.type == "cpu":
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k, loop_order=loop_order)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or the CPU, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    rc = launch(_entry(), a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                m, n, k, block_m, block_n, block_k, _LOOP_ORDERS[loop_order])
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc} "
                           f"at {(m, n, k)} with blocks "
                           f"{(block_m, block_n, block_k)}, {loop_order}")
    matmul.launches += 1
    return c


matmul.launches = 0
