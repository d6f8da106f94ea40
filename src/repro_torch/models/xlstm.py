"""xLSTM blocks, in PyTorch: mLSTM (matrix memory, chunkwise-parallel) and
sLSTM (scalar memory, strictly recurrent).

The JAX package's ``repro.models.xlstm`` carried over.  mLSTM is
linear-attention-like: C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ, y_t = (C_t q_t) /
max(|n_t·q_t|, 1); its chunkwise form is an intra-chunk decay-masked
product plus a recurrent (H, Pv, Pk) state carried across chunks, with the
log gates clipped to ±``_CLIP``.  sLSTM keeps a per-feature scalar state
with a block-diagonal recurrent matrix; it is sequential, and the port runs
it as JAX's ``lax.scan`` does, one token at a time, in eager PyTorch (about
20 kernels a token a layer on the card: its prefill is bound by the host,
PERF.md §7).  Neither has a Pallas kernel in the JAX package, and neither
has a hand-written one here.

The gates, decays and states are fp32, as in JAX; y is cast to the input's
dtype before the norm.  A sequence longer than one chunk must be a multiple
of it (``ssm.chunk_length``), as the JAX package asserts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import call_local, local_op
from repro_torch.models.common import ParamDef, Params, dense, rms_norm
from repro_torch.models.ssm import chunk_length

_CLIP = 15.0


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int = 4
    chunk: int = 128
    proj_factor: float = 2.0   # mLSTM up-projection

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_up(self) -> int:
        return int(self.d_model * self.proj_factor)


# =============================================================================
# mLSTM
# =============================================================================
def mlstm_defs(cfg: XLSTMConfig) -> Dict[str, ParamDef]:
    d, du, h = cfg.d_model, cfg.d_up, cfg.n_heads
    return {
        "w_up": ParamDef((d, 2 * du), ("embed", "mlp")),      # x branch + gate
        "wq": ParamDef((du, du), ("mlp", "heads")),
        "wk": ParamDef((du, du), ("mlp", "heads")),
        "wv": ParamDef((du, du), ("mlp", "heads")),
        "w_if": ParamDef((du, 2 * h), ("mlp", None), scale=0.02),
        "b_if": ParamDef((2 * h,), (None,), init="zeros"),
        "norm_g": ParamDef((du,), ("mlp",), init="ones"),
        "w_out": ParamDef((du, d), ("mlp", "embed")),
    }


def mlstm_apply(
    p: Params,
    cfg: XLSTMConfig,
    x: torch.Tensor,                     # (B, S, D)
    cache: Optional[Dict] = None,
    with_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Decode (``cache`` given): one step, returns (y, the new cache).
    Otherwise the chunked form: returns (y, None), or with ``with_state``
    (y, the (C, n) state after the whole sequence), which the JAX package's
    ``hybrid._mlstm_state_from_prefix`` computes from the same
    projections."""
    b, s, _ = x.shape
    h, du = cfg.n_heads, cfg.d_up
    hd = du // h

    up = dense(x, p["w_up"])
    xb, gate = up[..., :du], up[..., du:]
    q = dense(xb, p["wq"]).reshape(b, s, h, hd)
    k_raw = dense(xb, p["wk"]).reshape(b, s, h, hd)
    k = k_raw / (hd ** 0.5)
    v = dense(xb, p["wv"]).reshape(b, s, h, hd)
    gates = dense(xb, p["w_if"]) + p["b_if"]
    logi = torch.clamp(gates[..., :h].float(), -_CLIP, _CLIP)
    logf = local_op(F.logsigmoid, gates[..., h:].float())  # <= 0

    if cache is not None:
        return _mlstm_decode(p, cfg, x, q, k, v, logi, logf, gate, cache)

    L = chunk_length(s, cfg.chunk, "src/repro/models/xlstm.py:83")
    # the chunked form runs on each rank's own batch, every head
    # (``call_local``): its ops (cumsum's backward among them) then need
    # no DTensor rule
    y = call_local(_mlstm_chunks, (q, k, v, logi, logf),
                   (("batch", None, None, None),) * 3
                   + (("batch", None, None),) * 2,
                   ("batch", None, None), chunk=L).to(x.dtype)
    y = rms_norm(y, p["norm_g"]) * F.silu(gate)
    out = dense(y, p["w_out"])
    if not with_state:
        return out, None
    return out, _mlstm_state_from_prefix(k_raw, v, logi, logf)


def _mlstm_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logi: torch.Tensor, logf: torch.Tensor, chunk: int,
                  offsets=None) -> torch.Tensor:
    """mLSTM's chunked form of q, k, v (B, S, H, P) and the log input and
    forget gates (B, S, H), ``chunk`` positions a chunk: fp32
    (B, S, H * P)."""
    b, s, h, hd = q.shape
    L = chunk
    nc = s // L
    qc = q.reshape(b, nc, L, h, hd).float()
    kc = k.reshape(b, nc, L, h, hd).float()
    vc = v.reshape(b, nc, L, h, hd).float()
    li = logi.reshape(b, nc, L, h)
    cum = torch.cumsum(logf.reshape(b, nc, L, h), dim=2)  # (B, C#, L, H)

    # intra-chunk: D[t,s] = exp(cum_t - cum_s + logi_s), s <= t; laid out
    # (B, C#, H, t, s)
    cum_h, li_h = cum.permute(0, 1, 3, 2), li.permute(0, 1, 3, 2)
    ldecay = torch.clamp(cum_h[..., :, None] - cum_h[..., None, :]
                         + li_h[..., None, :], -_CLIP, _CLIP)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri, torch.exp(ldecay), 0.0)
    qh, kh, vh = (t.permute(0, 1, 3, 2, 4) for t in (qc, kc, vc))
    sd = torch.matmul(qh, kh.transpose(-1, -2)) * dmat    # (B,C#,H,t,s)
    num_intra = torch.matmul(sd, vh)                      # (B,C#,H,t,P)
    den_intra = sd.sum(dim=-1)                            # (B,C#,H,t)

    # chunk-boundary states:
    # C_end = sum_s exp(cum_L - cum_s + logi_s) v_s k_sᵀ
    w_end = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum + li,
                                  -_CLIP, _CLIP))         # (B, C#, L, H)
    wk = w_end[..., None] * kc                            # (B, C#, L, H, Pk)
    c_end = torch.einsum("bcshd,bcshe->bchde", vc, wk)
    n_end = wk.sum(dim=2)                                 # (B, C#, H, Pk)

    dec_end = torch.exp(cum[:, :, -1, :])                 # (B, C#, H)
    c_prev = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=q.device)
    n_prev = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    c_in, n_in = [], []
    for c in range(nc):
        c_in.append(c_prev)
        n_in.append(n_prev)
        c_prev = c_prev * dec_end[:, c, :, None, None] + c_end[:, c]
        n_prev = n_prev * dec_end[:, c, :, None] + n_end[:, c]
    c_in = torch.stack(c_in, dim=1)                       # (B, C#, H, Pv, Pk)
    n_in = torch.stack(n_in, dim=1)                       # (B, C#, H, Pk)

    scale_t = torch.exp(cum).permute(0, 1, 3, 2)          # (B, C#, H, t)
    num = num_intra + torch.matmul(qh, c_in.transpose(-1, -2)) \
        * scale_t[..., None]
    den = den_intra + torch.einsum("bchte,bche->bcht", qh, n_in) * scale_t
    y = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h * hd)


def _mlstm_state_from_prefix(k_raw: torch.Tensor, v: torch.Tensor,
                             logi: torch.Tensor, logf: torch.Tensor) -> Dict:
    """The (C, n) state after the whole sequence in one pass over it (the
    JAX package's ``hybrid._mlstm_state_from_prefix``, which scales k
    after its cast to fp32), the log forget gates summed over the whole
    sequence."""
    s, hd = k_raw.shape[1], k_raw.shape[-1]
    kf, vf = k_raw.float() / (hd ** 0.5), v.float()
    cum = torch.cumsum(logf, dim=1)                       # (B, S, H)
    w = torch.exp(torch.clamp(cum[:, -1:, :] - cum + logi, -_CLIP, _CLIP))
    wk = w[..., None] * kf
    return {"c": torch.einsum("bshd,bshe->bhde", vf, wk), "n": wk.sum(dim=1),
            "pos": torch.tensor(s, dtype=torch.int32, device=k_raw.device)}


def _mlstm_decode(p, cfg, x, q, k, v, logi, logf, gate, cache):
    b = x.shape[0]
    du = cfg.d_up
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i1 = torch.exp(logi[:, 0])                            # (B, H)
    f1 = torch.exp(logf[:, 0])
    c_new = cache["c"] * f1[:, :, None, None] + torch.einsum(
        "bhd,bhe->bhde", i1[..., None] * vf, kf)
    n_new = cache["n"] * f1[:, :, None] + i1[..., None] * kf
    # the read-out runs on each rank's own batch and heads (``call_local``):
    # its products fold (batch, heads) into one dim, which torch 2.11's
    # DTensor refuses where both are split
    y = call_local(_mlstm_readout, (qf, c_new, n_new),
                   (("batch", "heads", None), ("batch", "heads", None, None),
                    ("batch", "heads", None)), ("batch", "heads", None))
    y = y.reshape(b, 1, du).to(x.dtype)
    y = rms_norm(y, p["norm_g"]) * F.silu(gate)
    new_cache = {"c": c_new, "n": n_new, "pos": cache["pos"] + 1}
    return dense(y, p["w_out"]), new_cache


def _mlstm_readout(qf: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                   offsets=None) -> torch.Tensor:
    """The decode step's output from the new state: (C q) / max(|n q|, 1)."""
    num = torch.einsum("bhe,bhde->bhd", qf, c)
    den = torch.einsum("bhe,bhe->bh", qf, n)
    return num / torch.clamp(torch.abs(den), min=1.0)[..., None]


def mlstm_init_cache(cfg: XLSTMConfig, batch: int, device=None):
    h = cfg.n_heads
    hd = cfg.d_up // h
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# =============================================================================
# sLSTM
# =============================================================================
def slstm_defs(cfg: XLSTMConfig) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        # input projections for z, i, f, o gates
        "w_x": ParamDef((d, 4 * d), ("embed", "mlp")),
        # block-diagonal recurrent weights: per head (hd, 4*hd)
        "w_r": ParamDef((h, hd, 4 * hd), (None, None, None), scale=0.02),
        "b": ParamDef((4 * d,), (None,), init="zeros"),
        "norm_g": ParamDef((d,), ("embed",), init="ones"),
    }


def _slstm_step(w_r: torch.Tensor, bias: torch.Tensor, cfg: XLSTMConfig,
                carry, xt: torch.Tensor):
    """One recurrent step; xt: (B, 4*D) pre-activation from the input
    projection; ``w_r`` the recurrent weights in fp32 (JAX promotes them
    against the fp32 state)."""
    h_prev, c_prev, n_prev, m_prev = carry
    b = h_prev.shape[0]
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, hh, hd),
                       w_r).reshape(b, 4 * cfg.d_model)
    pre = xt + rec + bias
    z, i_pre, f_pre, o = torch.chunk(pre, 4, dim=-1)
    logi = torch.clamp(i_pre, -_CLIP, _CLIP)
    logf = local_op(F.logsigmoid, f_pre)
    m_new = torch.maximum(logf + m_prev, logi)
    i_s = torch.exp(logi - m_new)
    f_s = torch.exp(logf + m_prev - m_new)
    c_new = f_s * c_prev + i_s * torch.tanh(z)
    n_new = f_s * n_prev + i_s
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1.0)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_scan(p: Params, cfg: XLSTMConfig, x: torch.Tensor,
               carry) -> Tuple[torch.Tensor, Tuple]:
    """The sLSTM over x (B, S, D) token by token from ``carry``: returns
    the normed outputs in x's dtype and the carry after the last token."""
    xp = dense(x, p["w_x"])                               # (B, S, 4D)
    # the token loop runs on each rank's own batch (``call_local``)
    hs, *carry = call_local(
        _slstm_loop, (xp, p["w_r"].float(), p["b"]) + tuple(carry),
        (("batch", None, None), (None, None, None), (None,))
        + (("batch", None),) * 4,
        (("batch", None, None),) + (("batch", None),) * 4, cfg=cfg)
    return rms_norm(hs.to(x.dtype), p["norm_g"]), tuple(carry)


def _slstm_loop(xp: torch.Tensor, w_r: torch.Tensor, bias: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor, cfg: XLSTMConfig, offsets=None):
    """The sLSTM steps over xp (B, S, 4D) from the carry (h, c, n, m):
    the outputs (B, S, D) fp32 and the carry after the last token."""
    carry, hs = (h, c, n, m), []
    for t in range(xp.shape[1]):
        carry, ht = _slstm_step(w_r, bias, cfg, carry, xp[:, t])
        hs.append(ht)
    return (torch.stack(hs, dim=1),) + carry


def _slstm_zero(batch: int, d: int, device):
    """(h, c, n, m): zeros, m at -``_CLIP``; four tensors."""
    return tuple(torch.full((batch, d), fill, dtype=torch.float32,
                            device=device) for fill in (0.0, 0.0, 0.0, -_CLIP))


def slstm_apply(
    p: Params,
    cfg: XLSTMConfig,
    x: torch.Tensor,
    cache: Optional[Dict] = None,
    with_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Decode (``cache`` given): one step, returns (y, the new cache).
    Otherwise the whole sequence, token by token: returns (y, None), or
    with ``with_state`` (y, the state after it).  Without a state the
    sequence obeys the chunk rule, as the JAX package's ``slstm_apply``
    (scanned a chunk at a time) asserts; the JAX package's prefill
    (``hybrid._slstm_full_with_state``) scans it whole and does not."""
    b, s, d = x.shape
    if cache is not None:
        carry = (cache["h"], cache["c"], cache["n"], cache["m"])
        pos = cache["pos"] + 1
    else:
        if not with_state:
            chunk_length(s, cfg.chunk, "src/repro/models/xlstm.py:223")
        carry = _slstm_zero(b, d, x.device)
        pos = torch.tensor(s, dtype=torch.int32, device=x.device)
    y, carry = slstm_scan(p, cfg, x, carry)
    if cache is None and not with_state:
        return y, None
    return y, {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3],
               "pos": pos}


def slstm_init_cache(cfg: XLSTMConfig, batch: int, device=None):
    h, c, n, m = _slstm_zero(batch, cfg.d_model, device)
    return {"h": h, "c": c, "n": n, "m": m,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
