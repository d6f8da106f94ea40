"""Oracle for the 2-D convolution kernel ("same" correlation): one library
convolution.

Used by tests and checks only; the port's path never calls it.  On the card
the caller turns TF32 off (``torch.backends.cudnn.allow_tf32``)."""
import torch
import torch.nn.functional as F


def conv2d_ref(img: torch.Tensor, flt: torch.Tensor) -> torch.Tensor:
    f = flt.shape[0]
    return F.conv2d(img[None, None], flt[None, None], padding=f // 2)[0, 0]
