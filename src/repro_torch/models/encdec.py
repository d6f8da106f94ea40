"""Encoder-decoder transformer (the SeamlessM4T backbone, audio frontend
stub), in PyTorch.

The JAX package's ``repro.models.encdec`` carried over.  The speech
frontend is a stub: the batch carries precomputed frame embeddings
``frames`` (B, T_enc, frontend_dim), cast to the model's dtype and
projected; the encoder is a bidirectional transformer over them, the
decoder a causal transformer with cross-attention to the encoder's output.

Both self-attentions' prefill run on the hand-written attention kernel:
the encoder's with ``causal=False`` at (B, H, T_enc, D), the decoder's
causal at the prompt's length; one launch a layer each.  Cross-attention
stays plain (``attention.chunked_attention``): its queries (the prompt)
and keys (the frames) differ in length, and the kernel takes one S for q,
k and v.  The JAX package scans its layers over stacked parameters; the
port holds ``enc`` and ``dec`` as ``ModuleList``s and loops.

Cache: {"self": the decoder's KV cache, stacked (dec_layers,) as a
transformer's; "cross": each decoder layer's K/V of the encoder output,
(dec_layers, B, T_enc, Hkv, D)}.  Decode writes the new token's K/V into
the cache passed in, in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.api import new_cache, shard_act, split_heads
from repro_torch.models.attention import (attend_heads, chunked_attention,
                                          gqa_apply, gqa_defs,
                                          gqa_init_cache)
from repro_torch.models.common import (ParamDef, Params, broadcast_cache,
                                       cross_entropy_from_hidden, dense,
                                       embed_lookup, mlp_apply, mlp_defs,
                                       remat_apply, rms_norm, stack_caches,
                                       stack_defs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import attn_config, update_stacked_cache


def _xattn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.eff_head_dim
    return {
        "wq": ParamDef((d, h * hd), ("embed", "heads")),
        "wk": ParamDef((d, hk * hd), ("embed", "kv")),
        "wv": ParamDef((d, hk * hd), ("embed", "kv")),
        "wo": ParamDef((h * hd, d), ("heads", "embed")),
    }


def encdec_defs(cfg: ArchConfig) -> Dict[str, Any]:
    enc_block = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": gqa_defs(attn_config(cfg)),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, gated=True),
    }
    dec_block = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": gqa_defs(attn_config(cfg)),
        "ln_x": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "xattn": _xattn_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, gated=True),
    }
    v = cfg.padded_vocab
    return {
        "frontend_proj": ParamDef((cfg.frontend_dim, cfg.d_model),
                                  (None, "embed")),
        "embed": ParamDef((v, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "enc": stack_defs(enc_block, cfg.enc_layers),
        "enc_ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "dec": stack_defs(dec_block, cfg.dec_layers),
        "final_ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), ("embed", "vocab"), scale=0.02),
    }


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """Frames (B, T, frontend_dim) -> the encoder's normed output
    (B, T, D), its self-attention on the kernel, not causal; each layer
    under the remat policy ``remat``."""
    acfg = attn_config(cfg)._replace(causal=False)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def layer(x, lp):
        h, _ = gqa_apply(lp["attn"], acfg, rms_norm(x, lp["ln1"]))
        x = x + h
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]), cfg.activation)
        return shard_act(x, ("batch", None, None))

    x = shard_act(dense(frames.to(dt), params["frontend_proj"]),
                  ("batch", None, None))
    for lp in params["enc"]:
        x = remat_apply(functools.partial(layer, lp=lp), remat, x)
    return rms_norm(x, params["enc_ln"])


def _cross_attend(cfg: ArchConfig, xp: Params, x: torch.Tensor,
                  enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.eff_head_dim
    q = split_heads(dense(x, xp["wq"]), h, hd, "heads")
    k, v = enc_kv
    out = attend_heads(chunked_attention, q, k, v)
    return dense(out.reshape(b, s, h * hd).to(x.dtype), xp["wo"])


def _enc_kv(cfg: ArchConfig, xp: Params, enc_out: torch.Tensor):
    hk, hd = cfg.n_kv_heads, cfg.eff_head_dim
    k = split_heads(dense(enc_out, xp["wk"]), hk, hd, "kv")
    v = split_heads(dense(enc_out, xp["wv"]), hk, hd, "kv")
    return k, v


def _dec_block(cfg: ArchConfig, lp: Params, x: torch.Tensor, enc_kv,
               cache=None):
    h, new_kv = gqa_apply(lp["attn"], attn_config(cfg),
                          rms_norm(x, lp["ln1"]), cache=cache)
    x = x + h
    x = x + _cross_attend(cfg, lp["xattn"], rms_norm(x, lp["ln_x"]), enc_kv)
    x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]), cfg.activation)
    return x, new_kv


def encdec_loss(cfg: ArchConfig, params: Params, batch: Dict,
                remat: str = "nothing_saveable", loss_chunks: int = 1,
                **_) -> torch.Tensor:
    """The mean next-token cross-entropy, differentiable; any ``remat``
    but "none" recomputes each encoder and each decoder layer in the
    backward pass, as the JAX package does."""
    policy = "none" if remat == "none" else "nothing_saveable"
    enc_out = encode(cfg, params, batch["frames"], policy)

    def layer(x, lp):
        x = _dec_block(cfg, lp, x, _enc_kv(cfg, lp["xattn"], enc_out))[0]
        return shard_act(x, ("batch", None, None))

    x = shard_act(embed_lookup(params["embed"], batch["tokens"]),
                  ("batch", None, None))
    for lp in params["dec"]:
        x = remat_apply(functools.partial(layer, lp=lp), policy, x)
    hidden = rms_norm(x, params["final_ln"])
    return cross_entropy_from_hidden(hidden, params["lm_head"],
                                     batch["labels"], seq_chunks=loss_chunks)


def encdec_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                      device=None) -> Dict:
    a1 = gqa_init_cache(attn_config(cfg), batch, max_seq, dtype, device)
    hk, hd = cfg.n_kv_heads, cfg.eff_head_dim
    shape = (cfg.dec_layers, batch, cfg.frontend_len, hk, hd)
    cross = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"self": broadcast_cache(a1, (cfg.dec_layers,)), "cross": cross}


@torch.no_grad()
def encdec_prefill(cfg: ArchConfig, params: Params, batch: Dict,
                   max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """Encode ``frames``, then the decoder over ``tokens``, keeping each
    layer's self K/V and cross K/V; the last position's logits (B, 1, V)."""
    enc_out = encode(cfg, params, batch["frames"])
    x = embed_lookup(params["embed"], batch["tokens"])
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"a prompt of {s} positions does not fit a cache "
                         f"of max_seq={max_seq}")
    self_c = new_cache(lambda dev: broadcast_cache(gqa_init_cache(
        attn_config(cfg), b, max_seq, x.dtype, dev), (cfg.dec_layers,)),
        b, max_seq, x.device)
    cross = []
    for i, lp in enumerate(params["dec"]):
        kv = _enc_kv(cfg, lp["xattn"], enc_out)
        cross.append({"k": kv[0], "v": kv[1]})
        x, new_kv = _dec_block(cfg, lp, x, kv)
        for name, t in new_kv.items():
            self_c[name][i, :, :s] = t
    self_c["pos"].fill_(s)
    x = rms_norm(x[:, -1:], params["final_ln"])
    return dense(x, params["lm_head"]), {"self": self_c,
                                         "cross": stack_caches(cross)}


@torch.no_grad()
def encdec_decode(cfg: ArchConfig, params: Params, cache: Dict,
                  batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode; the self cache passed in is updated in place."""
    sc, cc = cache["self"], cache["cross"]
    x = embed_lookup(params["embed"], batch["tokens"])
    news = []
    for i, lp in enumerate(params["dec"]):
        x, new_kv = _dec_block(cfg, lp, x, (cc["k"][i], cc["v"][i]),
                               cache={k: v[i] for k, v in sc.items()})
        news.append(new_kv)
    new_self = update_stacked_cache(cfg, sc, stack_caches(news))
    x = rms_norm(x, params["final_ln"])
    return dense(x, params["lm_head"]), {"self": new_self, "cross": cc}
