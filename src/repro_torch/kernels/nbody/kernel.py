"""O(N²) gravitational accelerations for Hopper: the wrapper, its launch
count, its split rule and its plain PyTorch version.

Replaces the Pallas TPU kernel ``nbody`` (body ``_nbody_kernel``) of
``src/repro/kernels/nbody/kernel.py``: for bodies (x, y, z, m),
a_i = Σ_j m_j · d_ij · (|d_ij|² + ε)^{-3/2} with d_ij = p_j − p_i and
ε = 1e-3 added unsquared; the output is (N, 4) with column 3 zero.

The CUDA kernel is ``repro_torch/csrc/nbody.cu``.  What bounds it is the
instruction stream: at least 12 fp32 instructions and one rsqrt a pair
(``issue_floor_ms``).  Each thread holds ``BODIES_PER_THREAD`` bodies in
registers, so one shared-memory read of a streamed body feeds that many
pairs; a block owns BLOCK_I bodies (``block_threads`` threads) and streams
BLOCK_J bodies at a time through shared memory.  Below 128 bodies a block,
``j_lanes`` threads share each body, each taking every lanes-th body of a
tile, so that a block is a full warp.  When the blocks make fewer than
``SPLIT_WAVES`` waves of ``RESIDENT_WARPS_PER_SM`` warps on each SM (at
N = 16384 they do not even fill one; at 131072 more, shorter blocks shorten
the last wave's tail), the j range is cut into runs of whole BLOCK_J tiles
(``split_count``), one a block; their partial sums go to a workspace this
wrapper allocates and are added in run order by a second kernel, so two
launches give the same bits.
J_UNROLL is the unroll factor of the loop over a lane's bodies of a tile
(a template), lowered by the C entry to the largest that divides a lane's
share of a tile: in the space, BLOCK_I 8 with BLOCK_J 32 gives 16 lanes 2
bodies each, so there J_UNROLL 4 runs the same kernel as J_UNROLL 2 and
the two are one code path under two configurations.  KEEP_PAIRWISE is
priced by the workload model only.

``nbody`` launches the kernel for CUDA tensors and raises when the build or
the launch fails; it takes ``nbody_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import cdiv, entry, launch, sm_count

SOURCE = "nbody.cu"
J_UNROLLS = (1, 2, 4)          # compiled unroll factors
MAX_BLOCK_I = 1024             # bodies a block: 256 threads of 4
MAX_BLOCK_J = 2048             # shared-memory body tile: 32 KB
BODIES_PER_THREAD = 4          # bodies i a thread holds in registers
RESIDENT_WARPS_PER_SM = 24     # three blocks of 256 threads, <= 85 registers
SPLIT_WAVES = 8                # waves of blocks the j-split aims for
PAIRS_PER_CHUNK = 2**24        # plain version: (rows, N, 3) intermediates
FP32_INSTRUCTIONS_PER_PAIR = 12   # 3 FADD, 3 FFMA (r²), 3 FMUL, 3 FFMA (sums)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
_SUM_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_nbody_f32", _ARGTYPES)


@functools.cache
def _sum_entry():
    """The j-split's second kernel alone, (partial, out, n, splits): the
    C entry of ``_entry`` launches it after the first; this one lets it be
    timed and tested apart."""
    return entry(SOURCE, "repro_nbody_sum_splits_f32", _SUM_ARGTYPES)


def block_threads(block_i: int) -> int:
    """Threads of a block of ``block_i`` bodies: one a group of
    ``BODIES_PER_THREAD`` bodies, and at least one full warp."""
    return max(32, block_i // BODIES_PER_THREAD)


def j_lanes(block_i: int) -> int:
    """Threads that share each group of bodies, each taking every
    lanes-th body of a tile: 1 from 128 bodies a block up."""
    return block_threads(block_i) * BODIES_PER_THREAD // block_i


def split_count(n: int, block_i: int, block_j: int, sms: int,
                waves: int = SPLIT_WAVES) -> int:
    """Runs of whole BLOCK_J tiles the j range is cut into, one a block:
    as many (every run non-empty, runs as short as the tiles allow) as it
    takes for the ``cdiv(n, block_i)`` blocks to make ``waves`` waves of
    ``RESIDENT_WARPS_PER_SM`` warps on each of the ``sms`` SMs; 1 when they
    make them alone.  The wrapper takes ``SPLIT_WAVES``; other values are
    for timing the rule against."""
    warps = cdiv(n, block_i) * block_threads(block_i) // 32
    tiles = cdiv(n, block_j)
    target = sms * RESIDENT_WARPS_PER_SM * waves
    want = min(tiles, target // max(warps, 1))
    if want <= 1:
        return 1
    return cdiv(tiles, cdiv(tiles, want))


def issue_floor_ms(n: int, fp32_flops: float) -> float:
    """The least time the fp32 pipes take to issue
    ``FP32_INSTRUCTIONS_PER_PAIR`` instructions for each of the n² pairs,
    a lane retiring one a clock (``fp32_flops`` / 2, an FMA counting 2)."""
    return FP32_INSTRUCTIONS_PER_PAIR * float(n) ** 2 / (fp32_flops / 2) * 1e3


def _check(bodies: torch.Tensor, block_i: int, block_j: int,
           j_unroll: int) -> None:
    if bodies.dtype != torch.float32:
        raise TypeError(f"nbody takes float32 bodies, got {bodies.dtype}")
    if bodies.dim() != 2 or bodies.shape[1] != 4:
        raise ValueError(f"nbody takes (N, 4) bodies, got "
                         f"{tuple(bodies.shape)}")
    if not bodies.is_contiguous():
        raise ValueError("nbody takes contiguous bodies")
    if (not BODIES_PER_THREAD <= block_i <= MAX_BLOCK_I
            or block_i & (block_i - 1)):
        raise ValueError(f"block_i must be a power of two in "
                         f"[{BODIES_PER_THREAD}, {MAX_BLOCK_I}] (whole "
                         f"groups of {BODIES_PER_THREAD} bodies, sharing a "
                         f"warp evenly below 128), got {block_i}")
    if j_unroll not in J_UNROLLS:
        raise ValueError(f"j_unroll must be one of {J_UNROLLS}, got "
                         f"{j_unroll}")
    lanes = j_lanes(block_i)
    if (not 1 <= block_j <= MAX_BLOCK_J or block_j % j_unroll
            or block_j % lanes):
        raise ValueError(f"block_j must be in [1, {MAX_BLOCK_J}] and a "
                         f"multiple of j_unroll and of the {lanes} lanes "
                         f"that share a tile, got {block_j}, {j_unroll}")
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
    splits = split_count(n, block_i, block_j, sm_count(bodies.device))
    workspace = (torch.empty((splits, n, 4), dtype=torch.float32,
                             device=bodies.device) if splits > 1 else None)
    rc = launch(_entry(), bodies.device, bodies.data_ptr(), out.data_ptr(),
                None if workspace is None else workspace.data_ptr(),
                n, block_i, block_j, j_unroll, splits, softening)
    if rc != 0:
        raise RuntimeError(f"nbody kernel launch failed: CUDA error {rc} at "
                           f"N={n} with blocks {(block_i, block_j)}, "
                           f"j_unroll={j_unroll}, {splits} splits")
    nbody.launches += 1
    return out


nbody.launches = 0
