"""A plain reference of the port's MLA (multi-head latent attention) layer,
prefill forward, as ``repro_torch.models.attention.mla_apply`` computes it:

    q      = x W_q, split per head into q_nope (D_nope) and q_rope (D_rope)
    c_kv   = x W_dkv                      (the latent, rank R)
    k_nope = c_kv W_uk,  v = c_kv W_uv    (per head, D_nope and D_v)
    k_rope = RoPE(x W_kr)                 (one rotary key shared by the heads)
    q_rope = RoPE(q_rope)
    o      = softmax(mask([q_nope | q_rope] [k_nope | k_rope]^T
                          / sqrt(D_nope + D_rope)) v,   causal, per head
    y      = o W_o

in plain ``torch`` and float32, with the matrix products' TF32 switched
off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False) unless the caller asks for the
TF32 control.  It imports neither JAX nor any kernel or module of the
port.  RoPE rotates interleaved pairs (x[2i], x[2i + 1]) by position times
theta^(-2i / D_rope), as the port's ``apply_rope`` does.

Departures from DeepSeek-V2 (``deepseek-ai/DeepSeek-V2``'s config.json),
which the port's MLA shares and this reference keeps, so that the two
compute the same function:

* no query compression: DeepSeek-V2 computes q from a latent of rank
  ``q_lora_rank`` 1536 with an RMSNorm on it; here q = x W_q;
* no RMSNorm on the latent c_kv (DeepSeek-V2 normalises ``kv_a_layernorm``);
* plain RoPE (theta 10000) where DeepSeek-V2 uses YaRN (factor 40,
  ``mscale`` 0.707 and ``mscale_all_dim`` 0.707), which would also multiply
  the softmax scale by mscale^2, about 1.59.

None of them changes the attention core's shapes or its work: q and K at
D_nope + D_rope = 192, V at 128 (DeepSeek-V2's widths).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in float32 products on the card on or off for the block (the
    CPU computes float32 products in float32 either way)."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by its position along S: pairs (x[2i],
    x[2i + 1]) by the angle pos * theta^(-2i / D)."""
    s, d = x.shape[1], x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq                                               # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).reshape(x.shape)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax(mask(q k^T / sqrt(D))) v of q, k (B, S, H, D) and v (B, S, H,
    Dv), causal, one batch row at a time; (B, S, H, Dv) in q's dtype."""
    b, s, h, d = q.shape
    out = torch.empty(q.shape[:3] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    later = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    for i in range(b):
        scores = torch.einsum("shd,thd->hst", q[i], k[i]) / math.sqrt(d)
        p = torch.softmax(scores.masked_fill(later, float("-inf")), dim=-1)
        out[i] = torch.einsum("hst,thd->shd", p, v[i])
    return out


def mla_prefill(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                n_heads: int, nope_dim: int, rope_dim: int, v_dim: int,
                rope_theta: float = 10000.0,
                tf32: bool = False) -> torch.Tensor:
    """The layer's output (B, S, d_model) for x (B, S, d_model), causal
    from position 0, in float32; ``params`` holds ``wq`` (d, H (D_nope +
    D_rope)), ``w_dkv`` (d, R), ``w_uk`` (R, H D_nope), ``w_uv`` (R, H
    D_v), ``w_kr`` (d, D_rope) and ``wo`` (H D_v, d), as the port's
    ``mla_defs``.  ``tf32``: the control, every product in TF32."""
    p = {k: t.float() for k, t in params.items()}
    x = x.float()
    b, s, _ = x.shape
    h = n_heads
    with matmul_precision(tf32):
        q = (x @ p["wq"]).reshape(b, s, h, nope_dim + rope_dim)
        c_kv = x @ p["w_dkv"]
        k_rope = rope((x @ p["w_kr"])[:, :, None, :], rope_theta)
        k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope_dim)
        v = (c_kv @ p["w_uv"]).reshape(b, s, h, v_dim)
        q = torch.cat([q[..., :nope_dim], rope(q[..., nope_dim:],
                                               rope_theta)], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_dim)], dim=-1)
        o = causal_attention(q, k, v)
        return o.reshape(b, s, h * v_dim) @ p["wo"]
