"""Tiled fp32 GEMM for Hopper's tensor cores: the wrapper, its launch count
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``matmul`` (body ``_matmul_kernel``) of
``src/repro/kernels/matmul/kernel.py``: C = A·B in fp32 with an fp32
accumulator swept over K in BLOCK_K steps, the K tail masked, and
``loop_order`` choosing the raster of output tiles.

The CUDA kernel is ``repro_torch/csrc/matmul.cu``; its header says what
bounds each shape on the H100 (the tensor cores at 2048³, reading B for
skinny products) and how it takes fp32-accurate products by 3xTF32
(``csrc/tf32x3.cuh``): 128 x 128 sub-tiles on wgmma fed by TMA where
``wgmma_path`` holds, else on mma.sync fed by a cp.async ring.
BLOCK_M, BLOCK_N and LOOP_ORDER change the code path; BLOCK_K is the unit
of split-K, which shares the K sweep among blocks when the output tiles
fill less than half of the blocks the card holds at once (``split_count``);
ACC_F32 is ignored, as the Pallas kernel ignores it.

``matmul`` launches the kernel for CUDA tensors and raises when the build
or the launch fails; it takes ``matmul_plain`` only for tensors on the CPU
(the analogue of Pallas interpret mode, for the tests).  ``matmul.launches``
counts its launches, ``matmul.wgmma_launches`` those that the C entry
reports it ran on the wgmma path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import tf32x3
from repro_torch.kernels.common import cdiv, entry, launch, sm_count

SOURCE = "matmul.cu"
BLOCKS_PER_SM = 2            # blocks an SM holds at once (at most 105 KB of
                             # shared memory each, registers for two)
_LOOP_ORDERS = {"mnk": 0, "nmk": 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1
_WGMMA = -1                  # the C entry's return for a launch on wgmma
_CHUNK = 32                  # the K depth of one staged chunk


@functools.cache
def _entry():
    return entry(SOURCE, "repro_matmul_f32", _ARGTYPES)


def split_count(m: int, n: int, k: int, block_m: int, block_n: int,
                block_k: int, sms: int) -> int:
    """How many blocks share each output tile's K sweep: as many runs of
    whole BLOCK_K steps (every run non-empty, runs as short as the steps
    allow) as one wave of blocks holds, a wave being ``BLOCKS_PER_SM``
    blocks on each of the ``sms`` SMs; 1 when the tiles alone fill it."""
    tiles = cdiv(m, block_m) * cdiv(n, block_n)
    steps = cdiv(k, block_k)
    want = min(steps, (sms * BLOCKS_PER_SM) // max(tiles, 1))
    if want <= 1:
        return 1
    return cdiv(steps, cdiv(steps, want))


def wgmma_path(m: int, n: int, k: int, block_m: int, block_n: int,
               block_k: int, splits: int, aligned: bool = True) -> bool:
    """Whether ``matmul.cu`` runs the call's 128 x 128 sub-tiles on wgmma
    and TMA (the C entry decides; this is its rule, for the tests): the
    sub-tile is 128 x 128, the operands take 16-byte copies (K, N, BLOCK_N
    and a split's K multiples of 4 floats, both bases 16-byte ``aligned``),
    M and N at least 128, K positive, and a split's K whole 32-deep
    chunks."""
    split_k = cdiv(cdiv(k, block_k), splits) * block_k if splits > 1 else k
    vec = (k % 4 == 0 and n % 4 == 0 and block_n % 4 == 0
           and split_k % 4 == 0 and aligned)
    return (vec and block_m >= 128 and block_n >= 128 and m >= 128
            and n >= 128 and k > 0 and (splits == 1 or split_k % _CHUNK == 0))


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
    """The kernel's arithmetic in plain PyTorch: A and B split into TF32
    big and small parts (``tf32x3.split``, rounded on the fp32 bits as
    ``cvt.rna`` rounds), each BLOCK_K step's three products added in fp32,
    the K sweep cut into the kernel's splits (``split_count`` with the SMs
    of the operands' card) and the partials added in split order.  Slicing
    past an edge stops at it, which masks the ragged K tail.  The raster (``loop_order``) and
    the order of the sums inside one tensor-core product do not change what
    this computes beyond fp32 rounding."""
    m, k = a.shape
    n = b.shape[1]
    splits = split_count(m, n, k, block_m, block_n, block_k,
                         sm_count(a.device))
    steps = cdiv(k, block_k)
    per = cdiv(steps, splits)
    c = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    if k == 0:
        return c
    a_parts, b_parts = tf32x3.split(a), tf32x3.split(b)
    for s in range(splits):
        part = None
        for step in range(s * per, min(steps, (s + 1) * per)):
            ks = slice(step * block_k, (step + 1) * block_k)
            part = tf32x3.product(tuple(x[:, ks] for x in a_parts),
                                  tuple(x[ks] for x in b_parts), part)
        c = part if s == 0 else c + part
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
    splits = split_count(m, n, k, block_m, block_n, block_k,
                         sm_count(a.device))
    workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device) if splits > 1 else None)
    rc = launch(_entry(), a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if workspace is None else workspace.data_ptr(),
                m, n, k, block_m, block_n, block_k, _LOOP_ORDERS[loop_order],
                splits)
    if rc:
        if rc != _WGMMA:
            raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc} "
                               f"at {(m, n, k)} with blocks "
                               f"{(block_m, block_n, block_k)}, {loop_order}, "
                               f"{splits} splits")
        matmul.wgmma_launches += 1
    matmul.launches += 1
    return c


matmul.launches = 0
matmul.wgmma_launches = 0
