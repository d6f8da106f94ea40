"""The plain reference of the GEMM: C = A @ B in float64, and the control,
the same product in TF32 (the nearest precision below the configuration's
float32 with TF32 off).  Imports nothing but torch."""
from __future__ import annotations

import torch

from tf32 import tf32_matmul


def reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B in float64, on the operands' device."""
    return a.double() @ b.double()


def control(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B with TF32 products: what a port that gave up 3xTF32 returns."""
    return tf32_matmul(a, b)
