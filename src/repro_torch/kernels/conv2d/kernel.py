"""Single-channel "same" 2-D correlation for Hopper: the wrapper, its launch
count and its plain PyTorch version.

Replaces the Pallas TPU kernel ``conv2d`` (body ``_conv2d_kernel``) of
``src/repro/kernels/conv2d/kernel.py``: an (H, W) fp32 image correlated
with an odd F x F filter, zero outside the image, one (BY, BX) output tile
a program.

The CUDA kernel is ``repro_torch/csrc/conv2d.cu``.  It is bound by bytes
(reading the image and writing the output once).  A block walks its tile in
32 x 128 output sub-tiles whose halos a ring of DMA_DEPTH shared-memory
stages receives by cp.async, so that the next sub-tiles' halos are in
flight while this one's taps run; outside the image the copies zero-fill,
so no padded copy of the image is made.  A 4-column chunk of a row inside
the image that starts on a 16-byte boundary takes one 16-byte copy (every
interior chunk when W % 4 == 0 and the image is 16-byte aligned), the
chunks across the image's edges and of unaligned rows four 4-byte ones.  BY
and BX set the tile of one block; UNROLL_TAPS=1 takes register-blocked
taps compiled for F in ``UNROLLED_F`` (each thread reads its 8 x 4
outputs' window once, as 16-byte words, and sums the taps from
registers), 0 loops over the taps at run time; FILTER_SMEM=1 reads the
filter from ``__constant__`` memory (on the TPU "SMEM" is scalar memory,
the constant cache's counterpart), 0 from device memory, staged by each
block; DMA_DEPTH is the number of ring stages.

``conv2d`` launches the kernel for CUDA tensors and raises when the build
or the launch fails; it takes ``conv2d_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import entry, launch

SOURCE = "conv2d.cu"
UNROLLED_F = (1, 3, 5, 7)      # filter sizes compiled with unrolled taps
MAX_F = 31                     # 4 halo stages + filter within 227 KB
MAX_DMA_DEPTH = 4              # stages of the halo ring
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_conv2d_f32", _ARGTYPES)


def _check(img: torch.Tensor, flt: torch.Tensor, by: int, bx: int,
           unroll_taps: int, filter_smem: int, dma_depth: int) -> None:
    if img.dtype != torch.float32 or flt.dtype != torch.float32:
        raise TypeError(f"conv2d takes float32, got {img.dtype} and "
                        f"{flt.dtype}")
    if img.dim() != 2:
        raise ValueError(f"conv2d takes an (H, W) image, got "
                         f"{tuple(img.shape)}")
    f = flt.shape[0] if flt.dim() == 2 else -1
    if flt.shape != (f, f) or f % 2 != 1 or f > MAX_F:
        raise ValueError(f"conv2d takes an odd F x F filter with F <= "
                         f"{MAX_F}, got {tuple(flt.shape)}")
    if img.device != flt.device:
        raise ValueError(f"operands on {img.device} and {flt.device}")
    if not (img.is_contiguous() and flt.is_contiguous()):
        raise ValueError("conv2d takes contiguous (row-major) operands")
    if min(by, bx) < 1:
        raise ValueError(f"block sizes must be positive, got {(by, bx)}")
    if unroll_taps not in (0, 1) or filter_smem not in (0, 1):
        raise ValueError(f"unroll_taps and filter_smem must be 0 or 1, got "
                         f"{unroll_taps!r} and {filter_smem!r}")
    if not 1 <= dma_depth <= MAX_DMA_DEPTH:
        raise ValueError(f"dma_depth must be in [1, {MAX_DMA_DEPTH}], got "
                         f"{dma_depth!r}")
    if unroll_taps and f not in UNROLLED_F:
        raise ValueError(f"unrolled taps are compiled for F in {UNROLLED_F}, "
                         f"got F={f}; pass unroll_taps=0")
    if img.numel() > _INT_MAX:
        raise ValueError("conv2d images must hold fewer than 2**31 elements")


def conv2d_plain(img: torch.Tensor, flt: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: F x F shifted
    multiply-adds over the zero-padded image, taps in row-major order."""
    h, w = img.shape
    f = flt.shape[0]
    padded = F.pad(img, (f // 2,) * 4)
    acc = torch.zeros_like(img)
    for dy in range(f):
        for dx in range(f):
            acc += flt[dy, dx] * padded[dy:dy + h, dx:dx + w]
    return acc


def conv2d(img: torch.Tensor, flt: torch.Tensor, *, by: int = 128,
           bx: int = 256, unroll_taps: int = 1, filter_smem: int = 1,
           dma_depth: int = 2) -> torch.Tensor:
    """"Same" correlation of ``img`` with ``flt`` (fp32), with the
    parameters of the conv2d space."""
    _check(img, flt, by, bx, unroll_taps, filter_smem, dma_depth)
    if img.device.type == "cpu":
        return conv2d_plain(img, flt)
    if img.device.type != "cuda":
        raise ValueError(f"conv2d runs on CUDA or the CPU, not {img.device}")
    h, w = img.shape
    f = flt.shape[0]
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if h == 0 or w == 0:
        return out
    rc = launch(_entry(), img.device, img.data_ptr(), flt.data_ptr(),
                out.data_ptr(), h, w, f, by, bx, unroll_taps, filter_smem,
                dma_depth)
    if rc != 0:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {rc} at "
                           f"{(h, w)}, F={f} with blocks {(by, bx)}, "
                           f"unroll_taps={unroll_taps}, "
                           f"filter_smem={filter_smem}, "
                           f"dma_depth={dma_depth}")
    conv2d.launches += 1
    return out


conv2d.launches = 0
