"""The 3xTF32 arithmetic of ``csrc/tf32x3.cuh`` in plain PyTorch, for the
plain versions of the kernels that compute on the tensor cores.

An fp32 value x is split into big = tf32(x) and small = tf32(x − big), each
rounded as ``cvt.rna.tf32.f32`` rounds: to nearest at bit 13, ties away
from zero, done here on the fp32 bits (adding half of the dropped range to
the magnitude, then clearing the low 13 bits).  A product is taken as
small·big + big·small + big·big in fp32; the products of TF32 factors are
exact in fp32, so only the order of the sums differs from the kernel's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOW_BITS = 13                    # fp32 mantissa bits TF32 drops
_HALF = 1 << (LOW_BITS - 1)      # half of the dropped range: 0x1000
_KEEP = -(1 << LOW_BITS)         # 0xffffe000 as an int32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna`` rounds;
    the result's low 13 bits are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _HALF) & _KEEP).view(torch.float32)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big = tf32(x), small = tf32(x − big)."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def product(a: Tuple[torch.Tensor, torch.Tensor],
            b: Tuple[torch.Tensor, torch.Tensor],
            acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc + a·b from split operands, in the kernels' order: small·big,
    big·small, then big·big."""
    (a_big, a_small), (b_big, b_small) = a, b
    out = torch.matmul(a_small, b_big)
    if acc is not None:
        out = acc + out
    out += torch.matmul(a_big, b_small)
    out += torch.matmul(a_big, b_big)
    return out
