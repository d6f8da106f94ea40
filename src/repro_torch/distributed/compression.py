"""Gradient compression for the slow cross-pod link, in PyTorch: the JAX
package's ``repro.distributed.compression``, its in-step numerics.

``quantize_dequantize_tree`` is the int8 symmetric round trip each
gradient leaf takes when the train step compresses cross-pod traffic
(``StepConfig.compress_cross_pod``): the scale is the leaf's largest
magnitude, values are rounded half to even onto [-127, 127] and scaled
back in fp32.  The explicit int8 all-reduce over a process group
(``cross_pod_int8_psum``) waits for the sharded step (ROADMAP.md, queue 1,
item 9).
"""
from __future__ import annotations

from typing import Dict

import torch


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(g / torch.clamp(scale, min=1e-20) * 127.0),
                    -127, 127)
    return q.to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale / 127.0


def quantize_dequantize_tree(grads: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """Per-leaf int8 round trip, each leaf back in its dtype."""
    def one(g):
        gf = g.float()
        scale = torch.max(torch.abs(gf))
        return _dequantize(_quantize(gf, scale), scale).to(g.dtype)

    return {k: one(g) for k, g in grads.items()}
