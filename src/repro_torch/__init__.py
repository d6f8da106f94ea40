"""PyTorch/CUDA port of the counter-guided autotuner, for NVIDIA Hopper.

The layout mirrors the JAX package ``repro`` module for module; this package
imports ``torch`` and ``numpy`` and nothing of JAX or of ``repro``.  Kernels
are written by hand for sm_90a (``csrc/``) and built at first use into
``build/repro_torch/`` at the checkout root.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
