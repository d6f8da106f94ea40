"""Oracle for the GEMM kernel: one library product in fp32.

Used by tests and checks only; the port's path never calls it.  On the card
the caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32``)."""
import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())
