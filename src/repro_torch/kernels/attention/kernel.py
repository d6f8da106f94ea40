"""Causal flash attention for Hopper: the wrapper, its launch count and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``flash_attention_single_head`` (body
``_flash_kernel``) of ``src/repro/kernels/attention/kernel.py``, and the
``flash_attention`` that vmaps it over batch and heads: for q, k, v of shape
(B, H, S, D), O = softmax(mask(Q Kᵀ · sm_scale)) V per head, with scale
1/√D by default, the causal mask and keys past S at −1e30.

The CUDA kernel is ``repro_torch/csrc/attention.cu``; its header says what
bounds it (the tensor cores, on the S(S+1)/2 causal pairs) and how a block
of 4 warps walks its BLOCK_Q query rows in 128-row sub-tiles, 32 rows a
warp, and the keys in 32-row sub-tiles, both products fp32-accurate by
3xTF32 (``csrc/tf32x3.cuh``) with an online softmax on the accumulator
fragments.  Every parameter of the space changes its code path: BLOCK_Q
(grid and work a block), BLOCK_K (granularity of the causal skip, which
works per query sub-tile), KEEP_P (p kept in registers or computed again
for the PV product) and Q_PREFETCH (one or two cp.async stages for K and
V).

The kernel is compiled at the head dims ``HEAD_DIMS``; any other D up to
``MAX_HEAD_DIM`` is zero-padded to the next of them (``padded_head_dim``)
and the padding sliced off the output, with the scale 1/√D of the caller's
D.  Above D = 128 a warp owns one m16 tile instead of two (a 64-row query
sub-tile), so that the accumulators and the shared tiles of every
configuration fit at D = 256.

``flash_attention`` checks its arguments, pads the head dim and calls the
custom operator ``repro_torch::flash_attention``, which the dispatcher
routes by device: on CUDA tensors it launches the kernel and raises when
the build or the launch fails, on CPU tensors it is the plain version, and
on fake tensors (the dry run, ``repro_torch.roofline.op_count``) its fake
implementation gives the output's shape, so that the dry run sees one
launch a call with the kernel's own work (``attention_flops``).  Its
output has no gradient: it refuses an input that requires one while grad
mode is on, since training reaches it through
``repro_torch.models.attention.KernelAttention``, whose backward
recomputes the attention in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import tf32x3
from repro_torch.kernels.common import entry, launch

SOURCE = "attention.cu"
SUB = 64                     # BLOCK_Q and BLOCK_K are multiples of it
HEAD_DIMS = (16, 32, 64, 80, 128, 192, 256)   # compiled head dimensions
MAX_HEAD_DIM = HEAD_DIMS[-1]
MAX_BLOCK = 1024             # largest BLOCK_Q / BLOCK_K (the space's)
MAX_Q_BLOCKS = 65535         # the grid's y extent
NEG_INF = -1e30
SCORES_PER_CHUNK = 2**26     # plain version: (heads, S, S) scores at once
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_attention_f32", _ARGTYPES)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
           block_k: int, keep_p: int, q_prefetch: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention takes float32 tensors, got "
                             f"{name} {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention takes (B, H, S, D) tensors, "
                             f"got {name} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention takes contiguous tensors; "
                             f"{name} is not")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must have one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}] (the "
                         f"largest compiled head dim), got {q.shape[3]}")
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if not (SUB <= b <= MAX_BLOCK and b % SUB == 0):
            raise ValueError(f"{name} must be a multiple of {SUB} in "
                             f"[{SUB}, {MAX_BLOCK}], got {b}")
    if keep_p not in (0, 1):
        raise ValueError(f"keep_p must be 0 or 1, got {keep_p}")
    if q_prefetch not in (1, 2):
        raise ValueError(f"q_prefetch must be 1 or 2, got {q_prefetch}")
    if q.numel() // max(q.shape[3], 1) * padded_head_dim(q.shape[3]) \
            > _INT_MAX:
        raise ValueError("flash_attention takes fewer than 2**31 elements "
                         "(the head dim padded)")


def padded_head_dim(d: int) -> int:
    """The compiled head dim the kernel runs a head of dim ``d`` at: the
    least of ``HEAD_DIMS`` at or above it."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}], got {d}")
    return next(h for h in HEAD_DIMS if h >= d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its arithmetic: both
    products by 3xTF32 (``tf32x3``: operands split into TF32 big and small
    parts, three products in fp32), scores scaled, then masked to −1e30,
    softmax, product with V; computed over chunks of the B·H heads so that
    the (heads, S, S) scores stay within ``SCORES_PER_CHUNK`` elements
    (256 MB).  The kernel's online softmax splits p before it divides by
    the row sum, this version after; both are fp32-accurate."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5) if sm_scale is None else float(sm_scale)
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    out = torch.empty_like(qf)
    masked = (~torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
              if causal else None)
    step = max(1, SCORES_PER_CHUNK // max(s * s, 1))
    for h0 in range(0, b * h, step):
        sc = tf32x3.product(tf32x3.split(qf[h0:h0 + step]),
                            tf32x3.split(kf[h0:h0 + step].transpose(1, 2)))
        sc = sc * scale
        if masked is not None:
            sc = sc.masked_fill(masked, NEG_INF)
        out[h0:h0 + step] = tf32x3.product(
            tf32x3.split(torch.softmax(sc, dim=-1)),
            tf32x3.split(vf[h0:h0 + step]))
    return out.reshape(b, h, s, d)


def attention_flops(shape, causal: bool) -> float:
    """The kernel's products' flops on (B, H, S, D) inputs: QKᵀ and PV,
    2·D each a (query, key) pair, over the S(S+1)/2 causal pairs a head
    (S² not causal); each is three TF32 products on the card (3xTF32)."""
    b, h, s, d = shape
    pairs = s * (s + 1) / 2 if causal else float(s) * s
    return 4.0 * b * h * d * pairs


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
            block_k: int, keep_p: int, q_prefetch: int, causal: bool,
            scale: float) -> torch.Tensor:
    """One launch of the kernel on checked, padded (B, H, S, D) tensors."""
    b, h, s, dp = q.shape
    if -(-s // block_q) > MAX_Q_BLOCKS:
        raise ValueError(f"S / block_q must be at most {MAX_Q_BLOCKS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention copies rows in 16-byte chunks: "
                         "the storage of q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = launch(_entry(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b * h, s, dp, block_q, block_k, keep_p,
                q_prefetch, int(bool(causal)), scale)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} at {tuple(q.shape)} with blocks "
                           f"{(block_q, block_k)}, keep_p={keep_p}, "
                           f"q_prefetch={q_prefetch}")
    flash_attention.launches += 1
    return out


@_launch.register_kernel("cpu")
def _plain(q, k, v, block_q, block_k, keep_p, q_prefetch, causal, scale):
    return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)


@_launch.register_fake
def _launch_fake(q, k, v, block_q, block_k, keep_p, q_prefetch, causal,
                 scale):
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 256, block_k: int = 256, keep_p: int = 1,
                    q_prefetch: int = 1, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, S, D) attention of fp32 ``q``, ``k``, ``v`` with the
    parameters of the attention space; D is any of 1 to ``MAX_HEAD_DIM``,
    padded to ``padded_head_dim(D)``."""
    _check(q, k, v, block_q, block_k, keep_p, q_prefetch)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention's output has no gradient: differentiate "
            "through repro_torch.models.attention.KernelAttention, whose "
            "backward recomputes the attention in plain PyTorch")
    d = q.shape[3]
    scale = 1.0 / (d ** 0.5) if sm_scale is None else float(sm_scale)
    dp = padded_head_dim(d)
    if dp != d:
        # zero columns change no score and give zero output columns
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    out = torch.ops.repro_torch.flash_attention(
        q, k, v, block_q, block_k, keep_p, q_prefetch, bool(causal), scale)
    return out if dp == d else out[..., :d].contiguous()


flash_attention.launches = 0
