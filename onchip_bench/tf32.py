"""A float32 product in TF32, the control's precision.  On a card the
tensor cores compute it (TF32 switched on for the one call); elsewhere the
operands are rounded to TF32's 10 mantissa bits, to nearest, and
multiplied in float32, which is what the tensor cores do with them."""
from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties away from
    zero as ``cvt.rna`` rounds."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float(), b.float()
    if a.device.type == "cuda":
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
    return to_tf32(a) @ to_tf32(b)
