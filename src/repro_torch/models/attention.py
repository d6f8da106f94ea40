"""Attention variants: GQA/MQA (with optional QKV bias) and DeepSeek-style
MLA (multi-head latent attention with a compressed KV cache), in PyTorch.

The JAX package's ``repro.models.attention`` carried over.  There, prefill
and training compute attention in plain JAX and name the Pallas kernel as
the TPU drop-in; here GQA and MLA prefill and training go through the
port's hand-written kernel
(``repro_torch.kernels.attention.kernel.flash_attention``,
``csrc/attention.cu``), causal or not as the config says (an encoder's
self-attention is not; RoPE is applied there too, as in JAX): q as
(B, H, S, D), K and V repeated from the kv heads to H heads (query head j
reads kv head j // (H / Hkv), the JAX package's ``(b, s, hkv, rep, d)``
order), all cast to fp32, scale 1/sqrt(D), the kernel's default
parameters, and the output cast back to the model's dtype.  MLA's q and K
are its [nope | rope] concatenations (192 at DeepSeek-V2's widths) and its
V keeps its own head dim (128), which the kernel takes unpadded.  The
wrapper takes its plain version only for CPU tensors; on the card a kernel
that fails to build or launch raises.

Training differentiates through ``KernelAttention``: its forward is the
kernel, its backward recomputes the attention in plain PyTorch from the
saved q, k and v (``plain_causal_attention``, or ``chunked_attention``
for the encoder's) and differentiates that, so the gradient is the one
the JAX package takes through its plain training attention.  The repeat
of K and V over the kv heads and the fp32 casts stay outside the
Function; autograd carries their gradients back to the kv heads and the
model's dtype.

Cross-attention (its query length differs from its key length, and the
kernel takes one S for q, k and v: ``chunked_attention``, JAX's
``_chunked_attention`` with ``causal=False``) and both decode paths (GQA's
and MLA's absorbed one over the latent cache) stay plain PyTorch, as the
JAX package computes them: decode is the dense matvec over the cache,
operands cast to fp32 where JAX accumulates in fp32
(``preferred_element_type``).

Cache layout (GQA):   {"k": (B, S_max, Hkv, D), "v": ..., "pos": int32}
Cache layout (MLA):   {"c_kv": (B, S_max, R), "k_rope": (B, S_max, Dr)}
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.api import call_local, split_heads
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.models.common import ParamDef, Params, apply_rope, dense

NEG_INF = -1e30
# plain causal attention (the kernel's backward recompute): query rows a
# chunk, bounding the (B, H, rows, S) scores
PLAIN_Q_CHUNK = 1024
# plain non-causal attention (cross-attention): keys a chunk, the JAX
# package's kv_chunk
KV_CHUNK = 1024


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    # MLA (deepseek) extras
    kv_lora_rank: int = 0          # 0 => plain GQA
    qk_rope_dim: int = 64
    v_head_dim: int = 0            # defaults to head_dim


# =============================================================================
# GQA
# =============================================================================
def gqa_defs(cfg: AttnConfig) -> Dict[str, ParamDef]:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), ("embed", "heads")),
        "wk": ParamDef((d, hk * hd), ("embed", "kv")),
        "wv": ParamDef((d, hk * hd), ("embed", "kv")),
        "wo": ParamDef((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), ("heads",), init="zeros")
        defs["bk"] = ParamDef((hk * hd,), ("kv",), init="zeros")
        defs["bv"] = ParamDef((hk * hd,), ("kv",), init="zeros")
    return defs


class KernelAttention(torch.autograd.Function):
    """Attention of fp32 (B, H, S, D) q and k and (B, H, S, Dv) v, K and V
    already repeated to H heads: the hand-written kernel forward; backward,
    the plain model
    attention recomputed from the saved q, k, v and differentiated
    (causal: ``plain_causal_attention`` over query chunks of ``chunk``
    rows; not causal: ``chunked_attention`` over key chunks of
    ``chunk``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().transpose(1, 2).requires_grad_()
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            if ctx.causal:
                out = plain_causal_attention(q, k, v, chunk=ctx.chunk)
            else:
                out = chunked_attention(q, k, v, chunk=ctx.chunk)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v),
                                             grad_out.transpose(1, 2))
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True,
                     chunk: int = KV_CHUNK) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k (B, S, Hkv, D) and v (B, S, Hkv,
    Dv) through the hand-written kernel (``KernelAttention``), causal or
    not; (B, S, H, Dv) in q's dtype.  ``chunk`` is the backward's plain
    recompute's."""
    h, hkv = q.shape[2], k.shape[2]
    rep = h // hkv
    qh = q.transpose(1, 2).float().contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(rep, dim=1).float()
              .contiguous() for t in (k, v))
    out = KernelAttention.apply(qh, kh, vh, causal, chunk)
    return out.transpose(1, 2).to(q.dtype)


def _heads_local(attend: Callable, rep: int, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, offsets, **kw):
    """``attend`` on this rank's query heads, each paired with the kv head
    its global index reads (query head j reads kv head j // ``rep``):
    where the kv heads are not split as the query heads are (replicated
    while the query heads are split), they are gathered head by head."""
    h0, kv0 = offsets[0][2], offsets[1][2]
    h = q.shape[2]
    if h0 != kv0 * rep or h != k.shape[2] * rep:
        idx = torch.arange(h0, h0 + h, device=k.device) // rep - kv0
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return attend(q, k, v, **kw)


def attend_heads(attend: Callable, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, **kw) -> torch.Tensor:
    """``attend(q, k, v, **kw)`` of q (B, S, H, D) over k, v (B, T, Hkv,
    D): on one device as it is; under a mesh on each rank's local batch
    and query heads (``call_local``), so that the kernel sees
    (B/d, H/m, S, D).  The output is laid out as q."""
    rep = q.shape[2] // k.shape[2]
    return call_local(
        functools.partial(_heads_local, attend, rep), (q, k, v),
        (("batch", None, "heads", None), ("batch", None, "kv", None),
         ("batch", None, "kv", None)),
        ("batch", None, "heads", None), **kw)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = KV_CHUNK) -> torch.Tensor:
    """Non-causal attention of q (B, S, H, D) over k (B, T, Hkv, D) and
    v (B, T, Hkv, Dv), T free, in plain PyTorch: the JAX package's
    ``_chunked_attention(causal=False)``, an online softmax over chunks of
    the keys, with its rounding (q scaled in its dtype, scores and
    statistics in fp32, p cast to V's dtype before the PV product).
    Returns fp32 (B, S, H, Dv)."""
    b, s, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = h // hkv
    qf = (q * (1.0 / math.sqrt(d))).reshape(b, s, hkv, rep, d).float()
    m = torch.full((b, hkv, rep, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, rep, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, rep, s, dv), dtype=torch.float32,
                      device=q.device)
    # the last chunk is short where JAX pads it and masks the pads to
    # -1e30: their p is exactly 0 either way
    for c0 in range(0, t, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        sij = torch.einsum("bshrd,bthd->bhrst", qf, kb.float())
        m_new = torch.maximum(m, sij.amax(dim=-1))
        p = torch.exp(sij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrst,bthv->bhrsv", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv)


def plain_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           chunk: int = PLAIN_Q_CHUNK) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k (B, S, Hkv, D) and
    v (B, S, Hkv, Dv) in plain PyTorch, as the JAX package's
    ``_chunked_attention`` rounds: q scaled in its dtype, scores in fp32,
    the unnormalized p cast to V's dtype before the PV product in fp32,
    then divided by its fp32 row sum; ``chunk`` query rows at a time,
    each over the keys up to its last row.  Returns fp32 (B, S, H, Dv)."""
    b, s, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = h // hkv
    qf = (q * (1.0 / math.sqrt(d))).reshape(b, s, hkv, rep, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=q.device)
    kv_pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, chunk):
        q1 = min(s, q0 + chunk)
        sij = torch.einsum("bshrd,bthd->bhrst", qf[:, q0:q1], kf[:, :q1])
        mask = kv_pos[None, :q1] <= torch.arange(q0, q1,
                                                 device=q.device)[:, None]
        sij = torch.where(mask, sij, NEG_INF)
        p = torch.exp(sij - sij.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhrst,bthv->bhrsv", p.to(v.dtype).float(),
                         vf[:, :q1]) / p.sum(dim=-1)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h, dv)
    return out


def _decode_local(rep: int, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  pos: torch.Tensor, offsets) -> torch.Tensor:
    """One-token attention of q (B, 1, H, D) over the cache kc, vc
    (B, T, Hkv, D) up to ``pos`` and the token's own k, v (B, 1, Hkv, D),
    on this rank's heads (``call_local``); the heads paired as
    ``_heads_local`` pairs them.  Returns fp32 (B, 1, H, D)."""
    h0, kv0 = offsets[0][2], offsets[1][2]
    b, _, h, hd = q.shape
    if h0 != kv0 * rep or h != k.shape[2] * rep:
        idx = torch.arange(h0, h0 + h, device=k.device) // rep - kv0
        k, v, kc, vc = (t.index_select(2, idx) for t in (k, v, kc, vc))
    hk = k.shape[2]
    t = kc.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = (q * scale).reshape(b, 1, hk, h // hk, hd).float()
    sij = torch.einsum("bshrd,bthd->bhrst", qf, kc.float())
    valid = torch.arange(t, device=q.device)[None, :] < pos
    sij = torch.where(valid, sij, NEG_INF)
    s_self = torch.einsum("bshrd,bshd->bhrs", qf, k.float())
    sij = torch.cat([sij, s_self[..., None]], dim=-1)
    pr = torch.softmax(sij, dim=-1)
    out = torch.einsum("bhrst,bthv->bhrsv",
                       pr[..., :t].to(vc.dtype).float(), vc.float())
    # current token's value: (B,Hk,rep,1,1)·(B,Hk,1,1,Dv)
    v_self = v[:, 0][:, :, None, None, :]
    out = out + pr[..., -1][..., None] * v_self.float()
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)


def gqa_apply(
    p: Params,
    cfg: AttnConfig,
    x: torch.Tensor,                     # (B, S, D)
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,        # decode: attend over the cache
    kv_chunk: int = KV_CHUNK,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill (``cache is None``): returns (y, {"k", "v"}), the roped K
    and V for the caller's cache.  Decode: returns (y, {"k_new",
    "v_new"}), the current token's K/V; the caller writes every layer's
    into the stacked cache at once (``update_stacked_cache``).
    ``kv_chunk`` is the chunk of the plain attention the backward
    recomputes (``KernelAttention``)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(dense(x, p["wq"], p.get("bq")), h, hd, "heads")
    k = split_heads(dense(x, p["wk"], p.get("bk")), hk, hd, "kv")
    v = split_heads(dense(x, p["wv"], p.get("bv")), hk, hd, "kv")

    if cache is None:
        pos = positions if positions is not None \
            else torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        out = attend_heads(kernel_attention, q, k, v, causal=cfg.causal,
                           chunk=kv_chunk)
        new_cache = {"k": k, "v": v}
    else:
        # single-token decode over the stored prefix plus the current token
        pos = cache["pos"]                          # scalar int32 tensor
        q = apply_rope(q, pos[None, None], cfg.rope_theta)
        k = apply_rope(k, pos[None, None], cfg.rope_theta)
        heads = ("batch", None, "heads", None)
        kv = ("batch", None, "kv", None)
        out = call_local(functools.partial(_decode_local, h // hk),
                         (q, k, v, cache["k"], cache["v"], pos),
                         (heads, kv, kv, kv, kv, ()), heads)
        new_cache = {"k_new": k, "v_new": v}

    y = dense(out.reshape(b, s, h * hd).to(x.dtype), p["wo"])
    return y, new_cache


def gqa_init_cache(cfg: AttnConfig, batch: int, max_seq: int, dtype,
                   device=None):
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_seq, hk, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_seq, hk, hd), dtype=dtype,
                         device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# =============================================================================
# MLA (DeepSeek-V2): compressed KV latent + decoupled RoPE key
# =============================================================================
def mla_defs(cfg: AttnConfig) -> Dict[str, ParamDef]:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dv = cfg.v_head_dim or hd
    return {
        # queries: nope part + rope part per head
        "wq": ParamDef((d, h * (hd + dr)), ("embed", "heads")),
        # KV joint compression to rank r; decompression to K_nope and V
        "w_dkv": ParamDef((d, r), ("embed", None)),
        "w_uk": ParamDef((r, h * hd), (None, "heads")),
        "w_uv": ParamDef((r, h * dv), (None, "heads")),
        # shared (per-token, head-agnostic) rotary key
        "w_kr": ParamDef((d, dr), ("embed", None)),
        "wo": ParamDef((h * dv, d), ("heads", "embed")),
    }


def mla_apply(
    p: Params,
    cfg: AttnConfig,
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    kv_chunk: int = PLAIN_Q_CHUNK,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill (``cache is None``): returns (y, {"c_kv", "k_rope"}), the
    latent and the roped shared key for the caller's cache, the attention
    through the kernel (``kernel_attention``: q and K at hd + dr, V at dv;
    ``kv_chunk`` query rows a chunk in its backward's plain recompute).
    Decode: returns (y, {"c_kv_new", "k_rope_new"})."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dv = cfg.v_head_dim or hd

    q = split_heads(dense(x, p["wq"]), h, hd + dr, "heads")
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    c_kv = dense(x, p["w_dkv"])                     # (B, S, R): the cache
    k_rope = dense(x, p["w_kr"])                    # (B, S, Dr) shared

    if cache is None:
        pos = positions if positions is not None \
            else torch.arange(s, device=x.device)[None, :]
        q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
        k_rope_r = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)
        k_nope = split_heads(dense(c_kv, p["w_uk"]), h, hd, "heads")
        v = split_heads(dense(c_kv, p["w_uv"]), h, dv, "heads")
        # concatenated effective head dims: [nope | rope]
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_r.expand(b, s, h, dr)], dim=-1)
        out = attend_heads(kernel_attention, q_full, k_full, v,
                           causal=True, chunk=kv_chunk)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope_r[:, :, 0, :]}
    else:
        pos = cache["pos"]
        q_rope = apply_rope(q_rope, pos[None, None], cfg.rope_theta)
        k_rope_r = apply_rope(k_rope[:, :, None, :], pos[None, None],
                              cfg.rope_theta)[:, :, 0, :]
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        t = ckv_c.shape[1]
        denom = math.sqrt(hd + dr)
        # absorbed attention: score = q_nope^T W_uk c_kv + q_rope^T k_rope
        wk = p["w_uk"].reshape(r, h, hd)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope.float(), wk.float())
        q_abs_c = q_abs.to(ckv_c.dtype).float()
        s_nope = torch.einsum("bshr,btr->bhst", q_abs_c, ckv_c.float())
        s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(),
                              kr_c.float())
        sij = (s_nope + s_rope) / denom
        valid = torch.arange(t, device=x.device)[None, :] < pos
        sij = torch.where(valid, sij, NEG_INF)
        # current token's own score (cache not yet updated)
        s_self = (torch.einsum("bshr,bsr->bhs",
                               q_abs.to(c_kv.dtype).float(), c_kv.float())
                  + torch.einsum("bshd,bsd->bhs", q_rope.float(),
                                 k_rope_r.float())) / denom
        sij = torch.cat([sij, s_self[..., None]], dim=-1)
        pr = torch.softmax(sij, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr",
                           pr[..., :t].to(ckv_c.dtype).float(),
                           ckv_c.float())
        ctx = ctx + torch.einsum("bhs,bsr->bshr", pr[..., -1], c_kv.float())
        wv = p["w_uv"].reshape(r, h, dv)
        out = torch.einsum("bshr,rhd->bshd", ctx.to(wv.dtype).float(),
                           wv.float())
        new_cache = {"c_kv_new": c_kv, "k_rope_new": k_rope_r}

    y = dense(out.reshape(b, s, h * dv).to(x.dtype), p["wo"])
    return y, new_cache


def mla_init_cache(cfg: AttnConfig, batch: int, max_seq: int, dtype,
                   device=None):
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
