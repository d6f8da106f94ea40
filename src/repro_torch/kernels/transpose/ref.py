"""Oracle for the transpose kernel: the transposed view.

Used by tests and checks only; the port's path never calls it."""
import torch


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    return x.T
