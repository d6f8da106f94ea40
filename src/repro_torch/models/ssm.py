"""Mamba2 (SSD) block, in PyTorch: the chunked parallel form for loss and
prefill, the O(1) recurrent step for decode.

The JAX package's ``repro.models.ssm`` carried over.  Within a chunk of L
positions the output is an attention-like product with a decay-masked
score matrix; across chunks a small recurrent state (H, P, N) is carried.
The JAX package computes all of it in plain JAX, outside any Pallas
kernel, and so does the port: products are ``torch.einsum``/``matmul``,
the depthwise causal conv is a sum of W shifted products.  The rounding
follows JAX's: the log decays, their cumulative sums, the decays and the
states in fp32; the output cast to the input's dtype before the gated
RMSNorm.

The scores' decay ``exp(cum_t - cum_s)`` overflows for s > t (cum falls
with t); as in JAX it is masked by ``torch.where`` after the product, so
the masked entries (inf or NaN there) never reach the output.

A prompt longer than one chunk must be a multiple of it
(``chunk_length``): the JAX package asserts it, and the port refuses it.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads, state N.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import call_local, local_op
from repro_torch.models.common import ParamDef, Params, dense, rms_norm


class Mamba2Config(NamedTuple):
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        # convolved channels: x plus B and C projections
        return self.d_inner + 2 * self.d_state


def chunk_length(s: int, chunk: int, where: str) -> int:
    """The chunk the parallel forms take for a sequence of ``s``: ``min(
    chunk, s)``, which must divide ``s``.  ``where`` names the JAX assert
    that refuses the same lengths."""
    length = min(chunk, s)
    if s % length:
        raise ValueError(
            f"a sequence of {s} positions is neither at most {chunk} nor a "
            f"multiple of it: the chunked scan takes no other length (the "
            f"JAX package asserts the same at {where}; ROADMAP.md, queue 3)")
    return length


def mamba2_defs(cfg: Mamba2Config) -> Dict[str, ParamDef]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {
        # in_proj -> [z (di), xBC (conv_dim), dt (H)]
        "w_in": ParamDef((d, 2 * di + 2 * n + h), ("embed", "mlp")),
        "conv_w": ParamDef((cfg.conv_width, cfg.conv_dim), (None, "mlp"),
                           scale=0.5),
        "conv_b": ParamDef((cfg.conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamDef((h,), (None,), init="zeros"),
        "dt_bias": ParamDef((h,), (None,), init="zeros"),
        "d_skip": ParamDef((h,), (None,), init="ones"),
        "norm_g": ParamDef((di,), ("mlp",), init="ones"),
        "w_out": ParamDef((di, d), ("mlp", "embed")),
    }


def _split_proj(p: Params, cfg: Mamba2Config, x: torch.Tensor):
    di = cfg.d_inner
    proj = dense(x, p["w_in"])
    z = proj[..., :di]
    xbc = proj[..., di:di + cfg.conv_dim]
    dt = proj[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _causal_conv(p: Params, cfg: Mamba2Config,
                 xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU: (B, S, conv_dim),
    the W shifted products summed in order, as the JAX package sums them."""
    w = p["conv_w"]                      # (W, conv_dim)
    s = xbc.shape[1]
    # the sequence dim is never split: each rank pads its own block
    xp = local_op(functools.partial(F.pad, pad=(0, 0, cfg.conv_width - 1,
                                                0)), xbc)
    out = 0
    for i in range(cfg.conv_width):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out + p["conv_b"])


def _decay_rates(p: Params, dt: torch.Tensor):
    """A = -exp(a_log) (H,) and dt = softplus(dt + dt_bias), both fp32."""
    a = -torch.exp(p["a_log"].float())
    return a, F.softplus(dt.float() + p["dt_bias"])


def mamba2_apply(
    p: Params,
    cfg: Mamba2Config,
    x: torch.Tensor,                     # (B, S, D)
    cache: Optional[Dict] = None,
    with_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Decode (``cache`` given): one step, returns (y, the new cache).
    Otherwise the chunked form: returns (y, None), or with ``with_state``
    (y, the conv and SSM state after the whole sequence), which the JAX
    package's ``_mamba_state_from_prefix`` computes from the same
    projection."""
    if cache is not None:
        return _mamba2_decode(p, cfg, x, cache)

    b, s, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    L = chunk_length(s, cfg.chunk, "src/repro/models/ssm.py:92")
    nc = s // L

    z, xbc_raw, dt = _split_proj(p, cfg, x)
    xbc = _causal_conv(p, cfg, xbc_raw)
    xs = xbc[..., :di].reshape(b, nc, L, h, pd).float()
    bm = xbc[..., di:di + n].reshape(b, nc, L, n).float()   # B_t (G=1)
    cm = xbc[..., di + n:].reshape(b, nc, L, n).float()     # C_t

    a, dt = _decay_rates(p, dt)
    dt = dt.reshape(b, nc, L, h)
    # the chunked scan runs on each rank's own batch, every head
    # (``call_local``): its ops (cumsum's backward among them) then need
    # no DTensor rule
    y = call_local(_chunked_scan, (xs, bm, cm, dt, a),
                   (("batch", None, None, None, None),
                    ("batch", None, None, None), ("batch", None, None, None),
                    ("batch", None, None, None), (None,)),
                   ("batch", None, None))
    y = y + (xbc[..., :di].float()
             * torch.repeat_interleave(p["d_skip"], pd)[None, None, :])
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm_g"])
    out = dense(y, p["w_out"])
    if not with_state:
        return out, None
    return out, _state_from_prefix(cfg, xbc_raw, xbc, dt.reshape(b, s, h), a)


def _chunked_scan(xs: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor, offsets=None
                  ) -> torch.Tensor:
    """The SSD of xs (B, C#, L, H, P) with B_t, C_t (B, C#, L, N), the
    decay rates dt (B, C#, L, H) and A (H,): the intra-chunk products plus
    the chunk states carried across; fp32 (B, C# * L, H * P)."""
    b, nc, L, h, pd = xs.shape
    n = bm.shape[-1]
    cum = torch.cumsum(dt * a, dim=2)                     # (B, C#, L, H)

    # --- intra-chunk: decay-masked attention-like product -----------------
    # scores[b,c,h,t,s] = exp(cum_t - cum_s) * (C_t · B_s) * dt_s,  s <= t
    cb = torch.einsum("bctn,bcsn->bcts", cm, bm)
    cum_h = cum.permute(0, 1, 3, 2)                       # (B, C#, H, L)
    decay = torch.exp(cum_h[..., :, None] - cum_h[..., None, :])
    tri = torch.ones((L, L), dtype=torch.bool, device=xs.device).tril()
    scores = torch.where(tri, cb[:, :, None] * decay, 0.0) \
        * dt.permute(0, 1, 3, 2)[..., None, :]            # weight dt_s
    del decay
    y_intra = torch.matmul(scores, xs.permute(0, 1, 3, 2, 4))  # (B,C#,H,t,P)
    del scores

    # --- chunk boundary states -------------------------------------------
    # h_end[b,c,h,p,n] = sum_s exp(cum_L - cum_s) dt_s x_s (x) B_s
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dt       # (B, C#, L, H)
    h_end = torch.einsum("bcshp,bcsn->bchpn", w_end[..., None] * xs, bm)

    decay_end = torch.exp(cum[:, :, -1, :])               # (B, C#, H)
    hprev = torch.zeros((b, h, pd, n), dtype=torch.float32, device=xs.device)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * decay_end[:, c, :, None, None] + h_end[:, c]
    h_in = torch.stack(h_in, dim=1)                       # (B, C#, H, P, N)

    # --- inter-chunk contribution ----------------------------------------
    y_inter = torch.einsum("bctn,bchpn->bcthp", cm, h_in) \
        * torch.exp(cum)[..., None]

    return (y_intra.permute(0, 1, 3, 2, 4) + y_inter).reshape(
        b, nc * L, h * pd)


def _state_from_prefix(cfg: Mamba2Config, xbc_raw: torch.Tensor,
                       xbc: torch.Tensor, dt: torch.Tensor,
                       a: torch.Tensor) -> Dict:
    """The (conv, SSM) state after consuming the whole sequence, in one
    pass over it (the JAX package's ``hybrid._mamba_state_from_prefix``):
    the conv's input tail, and sum_s exp(cum_S - cum_s) dt_s x_s (x) B_s
    with cum over the whole sequence."""
    b, s, _ = xbc.shape
    di, n, hh, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    conv_tail = xbc_raw[:, s - (cfg.conv_width - 1):, :]
    xs = xbc[..., :di].reshape(b, s, hh, pd).float()
    bm = xbc[..., di:di + n].float()
    cum = torch.cumsum(dt * a, dim=1)                     # (B, S, H)
    w = torch.exp(cum[:, -1:, :] - cum) * dt
    hstate = torch.einsum("bshp,bsn->bhpn", w[..., None] * xs, bm)
    return {"conv": conv_tail, "h": hstate,
            "pos": torch.tensor(s, dtype=torch.int32, device=xbc.device)}


def _mamba2_decode(p: Params, cfg: Mamba2Config, x: torch.Tensor,
                   cache: Dict):
    """Single-token recurrent step; cache: the conv's input tail + the SSM
    state."""
    b = x.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt = _split_proj(p, cfg, x)                   # (B, 1, ·)
    conv_in = torch.cat([cache["conv"], xbc], dim=1)      # (B, W, conv_dim)
    out = torch.einsum("bwc,wc->bc", conv_in, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(out)                                    # (B, conv_dim)
    xs = xbc1[:, :di].reshape(b, h, pd).float()
    bm = xbc1[:, di:di + n].float()
    cm = xbc1[:, di + n:].float()

    a, dt1 = _decay_rates(p, dt[:, 0])                    # (H,), (B, H)
    decay = torch.exp(dt1 * a)                            # (B, H)
    hst = cache["h"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", dt1[:, :, None] * xs, bm)
    y = torch.einsum("bn,bhpn->bhp", cm, hst)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, di)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm_g"])
    new_cache = {"conv": conv_in[:, 1:], "h": hst, "pos": cache["pos"] + 1}
    return dense(y, p["w_out"]), new_cache


def mamba2_init_cache(cfg: Mamba2Config, batch: int, dtype, device=None):
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
