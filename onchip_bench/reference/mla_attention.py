"""The plain reference of DeepSeek-V2's latent-attention prefill core:
softmax(Q Kᵀ / √Dqk) V a head, causal, with q and k at Dqk and V (and the
output) at Dv, the softmax written out, in float64 and one batch row at a
time so that the scores fit; and the control, the same with the two
products in TF32 (the nearest precision below the configuration's float32
with TF32 off).  Imports nothing but torch."""
from __future__ import annotations

import torch

from tf32 import tf32_matmul


def _attend(q, k, v, matmul, dtype):
    """q, k (B, H, S, Dqk) and v (B, H, S, Dv), one batch row at a time in
    ``dtype``; (B, H, S, Dv)."""
    out = torch.empty(v.shape, dtype=dtype, device=q.device)
    s = q.shape[2]
    scale = q.shape[-1] ** -0.5
    later = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].to(dtype) for t in (q, k, v))
        scores = matmul(qi, ki.transpose(-1, -2)) * scale
        scores = scores.masked_fill(later, float("-inf"))
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        out[i] = matmul(e / e.sum(dim=-1, keepdim=True), vi)
    return out


def reference(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal softmax(Q Kᵀ / √Dqk) V in float64."""
    return _attend(q, k, v, torch.matmul, torch.float64)


def control(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """The same in float32 with TF32 products: what a port that gave up
    3xTF32 returns."""
    return _attend(q, k, v, tf32_matmul, torch.float32)
