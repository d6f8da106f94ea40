"""Decoder-only transformer LM: dense GQA, MLA and MoE variants, with an
optional vision embedding prefix (the VLM stub), in PyTorch.

The JAX package's ``repro.models.transformer`` carried over.  The JAX
package scans its layers over stacked parameters; the port holds one
module a layer (a ``ParamTree`` of ``lm_defs``, with ``blocks`` a
``ModuleList``: ``registry.Model.module``) and loops over them.  The KV
cache keeps the JAX layout, stacked along the layers: ``decode_step``
reads each layer's slice and writes every layer's new token in place at
``pos`` afterwards (``update_stacked_cache``).  Prompts are not masked
beyond the causal mask: a left-padded prompt attends to its pads, as in
the JAX package.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.api import index_copy_, new_cache, shard_act
from repro_torch.models.attention import (AttnConfig, gqa_apply, gqa_defs,
                                          gqa_init_cache, mla_apply,
                                          mla_defs, mla_init_cache)
from repro_torch.models.common import (ParamDef, Params, broadcast_cache,
                                       cross_entropy_from_hidden, dense,
                                       embed_lookup,
                                       mlp_apply, mlp_defs, remat_apply,
                                       rms_norm, stack_defs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import (MoEConfig, moe_apply, moe_apply_dropless,
                                    moe_defs)

# prefill switches the MoE layers from the dropless dispatch to the
# capacity dispatch above this many tokens (batch x prompt), as the JAX
# package does
MOE_PREFILL_CAPACITY_TOKENS = 65536


def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.eff_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim,
    )


def moe_config(cfg: ArchConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff or cfg.d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        n_shared=cfg.n_shared_experts,
    )


# =============================================================================
# Parameter definitions and the module
# =============================================================================
def block_defs(cfg: ArchConfig) -> Dict[str, Any]:
    acfg = attn_config(cfg)
    defs: Dict[str, Any] = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": mla_defs(acfg) if cfg.kv_lora_rank else gqa_defs(acfg),
    }
    if cfg.n_experts:
        defs["moe"] = moe_defs(moe_config(cfg))
    else:
        defs["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, gated=True)
    return defs


def lm_defs(cfg: ArchConfig) -> Dict[str, Any]:
    v = cfg.padded_vocab
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "blocks": stack_defs(block_defs(cfg), cfg.n_layers),
        "final_ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, v), ("embed", "vocab"),
                                   scale=0.02)
    if cfg.frontend == "vision":
        defs["vis_proj"] = ParamDef((cfg.frontend_dim, cfg.d_model),
                                    (None, "embed"))
    return defs


def _w_out(params: Params) -> torch.Tensor:
    w_out = params.get("lm_head")
    return params["embed"].t() if w_out is None else w_out


# =============================================================================
# Forward
# =============================================================================
def _attn(cfg: ArchConfig, lp: Params, h: torch.Tensor, **kw):
    fn = mla_apply if cfg.kv_lora_rank else gqa_apply
    return fn(lp["attn"], attn_config(cfg), h, **kw)


def _block_apply(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                 kv_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    h, _ = _attn(cfg, lp, rms_norm(x, lp["ln1"]), kv_chunk=kv_chunk)
    x = shard_act(x + h, ("batch", None, None))
    h = rms_norm(x, lp["ln2"])
    if cfg.n_experts:
        h, aux = moe_apply(lp["moe"], moe_config(cfg), h)
    else:
        h = mlp_apply(lp["mlp"], h, cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard_act(x + h, ("batch", None, None)), aux


def embed_inputs(cfg: ArchConfig, params: Params,
                 batch: Dict) -> torch.Tensor:
    x = embed_lookup(params["embed"], batch["tokens"])
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        vis = dense(batch["patch_embeds"].to(x.dtype), params["vis_proj"])
        x = torch.cat([vis, x], dim=1)
    return shard_act(x, ("batch", None, None))


def forward_hidden(cfg: ArchConfig, params: Params, batch: Dict,
                   remat: str = "nothing_saveable",
                   kv_chunk: int = 1024
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token (+prefix) embeddings -> final hidden states, layer by layer,
    each layer under the remat policy ``remat`` (``common.remat_apply``);
    and the MoE layers' summed auxiliary loss."""
    x = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["blocks"]:
        x, a = remat_apply(
            functools.partial(_block_apply, cfg, lp, kv_chunk=kv_chunk),
            remat, x)
        aux = aux + a
    return rms_norm(x, params["final_ln"]), aux


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict,
            remat: str = "nothing_saveable", kv_chunk: int = 1024,
            loss_chunks: int = 1) -> torch.Tensor:
    """The mean next-token cross-entropy (plus the MoE auxiliary loss),
    differentiable: every layer under the remat policy ``remat``, GQA
    attention on the kernel through ``KernelAttention`` (its backward
    recomputing the plain attention ``kv_chunk`` rows at a time)."""
    hidden, aux = forward_hidden(cfg, params, batch, remat, kv_chunk)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        hidden = hidden[:, batch["patch_embeds"].shape[1]:]
    ce = cross_entropy_from_hidden(hidden, _w_out(params), batch["labels"],
                                   seq_chunks=loss_chunks)
    return ce + aux


# =============================================================================
# Serving: prefill + decode
# =============================================================================
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
               device=None) -> Dict:
    """Zeros, every leaf with a leading layers axis (``pos`` too)."""
    acfg = attn_config(cfg)
    one = (mla_init_cache if cfg.kv_lora_rank else gqa_init_cache)(
        acfg, batch, max_seq, dtype, device)
    return broadcast_cache(one, (cfg.n_layers,))


def update_stacked_cache(cfg: ArchConfig, cache: Dict,
                         new_kv: Dict) -> Dict:
    """Write all layers' new-token K/V into the stacked cache at ``pos``,
    in place.  A ``pos`` past the cache's end writes its last slot, as
    the JAX package's ``dynamic_update_slice`` clamps its start."""
    names = (("c_kv", "c_kv_new"), ("k_rope", "k_rope_new")) \
        if cfg.kv_lora_rank else (("k", "k_new"), ("v", "v_new"))
    for name, new in names:
        buf = cache[name]
        at = torch.clamp(cache["pos"][:1].long(), max=buf.shape[2] - 1)
        index_copy_(buf, 2, at, new_kv[new])
    out = {name: cache[name] for name, _ in names}
    out["pos"] = cache["pos"] + 1
    return out


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Dict,
                batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: batch["tokens"]: (B, 1) -> (logits, new cache).

    Each layer attends over its slice of the stacked cache and emits only
    the new token's K/V; the stacked cache is written once after the last
    layer.  The cache passed in is updated in place (the JAX engine
    donates it)."""
    x = embed_lookup(params["embed"], batch["tokens"])
    news = []
    for i, lp in enumerate(params["blocks"]):
        cache_l = {k: v[i] for k, v in cache.items()}
        h, new_c = _attn(cfg, lp, rms_norm(x, lp["ln1"]), cache=cache_l)
        news.append(new_c)
        x = x + h
        h = rms_norm(x, lp["ln2"])
        if cfg.n_experts:
            h = moe_apply_dropless(lp["moe"], moe_config(cfg), h)
        else:
            h = mlp_apply(lp["mlp"], h, cfg.activation)
        x = x + h
    new_kv = {k: torch.stack([n[k] for n in news]) for k in news[0]}
    new_cache = update_stacked_cache(cfg, cache, new_kv)
    x = rms_norm(x, params["final_ln"])
    return dense(x, _w_out(params)), new_cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, batch: Dict,
            max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt, building the KV cache; returns the last
    position's logits (B, 1, V) and the cache.  The JAX package projects
    K/V twice (once for the cache, once in the attention); the port takes
    the attention's."""
    x = embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"a prompt of {s} positions does not fit a cache "
                         f"of max_seq={max_seq}")
    cache = new_cache(lambda dev: init_cache(cfg, b, max_seq, x.dtype, dev),
                      b, max_seq, x.device)
    for i, lp in enumerate(params["blocks"]):
        h, kv = _attn(cfg, lp, rms_norm(x, lp["ln1"]))
        for name, t in kv.items():
            cache[name][i, :, :s] = t
        x = x + h
        h = rms_norm(x, lp["ln2"])
        if cfg.n_experts:
            # the capacity dispatch keeps large prefills' routing local
            # (the JAX package's collective-bound fix); dropless below
            if b * s > MOE_PREFILL_CAPACITY_TOKENS:
                h, _ = moe_apply(lp["moe"], moe_config(cfg), h)
            else:
                h = moe_apply_dropless(lp["moe"], moe_config(cfg), h)
        else:
            h = mlp_apply(lp["mlp"], h, cfg.activation)
        x = x + h
    cache["pos"].fill_(s)
    x = rms_norm(x[:, -1:], params["final_ln"])
    return dense(x, _w_out(params)), cache
