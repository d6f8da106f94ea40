"""Hybrid and SSM language models, in PyTorch: Zamba2 (Mamba2 + shared
attention) and xLSTM (alternating mLSTM/sLSTM blocks).

The JAX package's ``repro.models.hybrid`` carried over.  Zamba2 organizes
its depth into superblocks of ``mamba_per_attn`` Mamba2 layers followed by
ONE shared transformer block (a single parameter set reused at every
superblock).  The JAX package scans the superblocks over stacked
parameters; the port holds ``supers`` as a ``ModuleList`` of superblocks,
each a ``ModuleList`` of its Mamba2 layers, and loops.  The shared block's
GQA prefill runs on the hand-written attention kernel (one launch a
superblock); everything else is plain PyTorch, as the JAX package computes
it in plain JAX.  xLSTM alternates mLSTM and sLSTM layers, held as
``pairs``.

Caches keep the JAX layout: Zamba2's Mamba2 states stacked (n_super, per)
and its shared block's KV cache stacked (n_super,); xLSTM's states stacked
(n_pairs,).  Decode writes the new states into the cache passed in, in
place, and every superblock's new K/V at ``pos`` after the last one
(``transformer.update_stacked_cache``).  Prefill takes the states from the
same projections as the outputs (``with_state``), where the JAX package
projects a second time; the numbers are the same.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.api import new_cache, shard_act
from repro_torch.models.attention import gqa_apply, gqa_defs, gqa_init_cache
from repro_torch.models.common import (ParamDef, Params, broadcast_cache,
                                       cross_entropy_from_hidden, dense,
                                       embed_lookup, mlp_apply, mlp_defs,
                                       remat_apply, rms_norm, stack_caches,
                                       stack_defs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import (Mamba2Config, mamba2_apply, mamba2_defs,
                                    mamba2_init_cache)
from repro_torch.models.transformer import attn_config, update_stacked_cache
from repro_torch.models.xlstm import (XLSTMConfig, mlstm_apply, mlstm_defs,
                                      mlstm_init_cache, slstm_apply,
                                      slstm_defs, slstm_init_cache)


def _write_layer(stacked: Dict, index, new: Dict) -> None:
    """A layer's new state into its slice of a stacked cache, in place;
    ``pos`` is advanced once for all layers by the caller."""
    for k, v in new.items():
        if k != "pos":
            stacked[k][index].copy_(v)


def _embed(params: Params, batch: Dict) -> torch.Tensor:
    return embed_lookup(params["embed"], batch["tokens"])


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(rms_norm(x, params["final_ln"]), params["lm_head"])


# =============================================================================
# Zamba2
# =============================================================================
def mamba_config(cfg: ArchConfig) -> Mamba2Config:
    return Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state)


def zamba2_defs(cfg: ArchConfig) -> Dict[str, Any]:
    per = cfg.mamba_per_attn
    assert cfg.n_layers % per == 0
    n_super = cfg.n_layers // per
    mamba_block = {
        "ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mamba": mamba2_defs(mamba_config(cfg)),
    }
    shared_block = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": gqa_defs(attn_config(cfg)),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, gated=True),
    }
    v = cfg.padded_vocab
    return {
        "embed": ParamDef((v, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "supers": stack_defs(stack_defs(mamba_block, per), n_super),
        "shared": shared_block,
        "final_ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), ("embed", "vocab"), scale=0.02),
    }


def _zamba_shared_apply(cfg: ArchConfig, sp: Params, x: torch.Tensor,
                        cache=None):
    h, new_c = gqa_apply(sp["attn"], attn_config(cfg),
                         rms_norm(x, sp["ln1"]), cache=cache)
    x = x + h
    x = x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"]), cfg.activation)
    return x, new_c


def zamba2_loss(cfg: ArchConfig, params: Params, batch: Dict,
                remat: str = "nothing_saveable", loss_chunks: int = 1,
                **_) -> torch.Tensor:
    """The mean next-token cross-entropy, differentiable.  As in the JAX
    package, any ``remat`` but "none" recomputes each Mamba2 layer, and
    each superblock (its Mamba2 layers and the shared block), in the
    backward pass ("nothing_saveable"); other options are not read."""
    policy = "none" if remat == "none" else "nothing_saveable"
    mcfg = mamba_config(cfg)

    def mamba_layer(x, lp):
        h, _ = mamba2_apply(lp["mamba"], mcfg, rms_norm(x, lp["ln"]))
        return x + h

    def superblock(x, sb):
        for lp in sb:
            x = remat_apply(functools.partial(mamba_layer, lp=lp), policy, x)
        return shard_act(_zamba_shared_apply(cfg, params["shared"], x)[0],
                         ("batch", None, None))

    x = shard_act(_embed(params, batch), ("batch", None, None))
    for sb in params["supers"]:
        x = remat_apply(functools.partial(superblock, sb=sb), policy, x)
    hidden = rms_norm(x, params["final_ln"])
    return cross_entropy_from_hidden(hidden, params["lm_head"],
                                     batch["labels"], seq_chunks=loss_chunks)


def zamba2_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                      device=None) -> Dict:
    per = cfg.mamba_per_attn
    n_super = cfg.n_layers // per
    m1 = mamba2_init_cache(mamba_config(cfg), batch, dtype, device)
    a1 = gqa_init_cache(attn_config(cfg), batch, max_seq, dtype, device)
    return {"mamba": broadcast_cache(m1, (n_super, per)),
            "attn": broadcast_cache(a1, (n_super,))}


@torch.no_grad()
def zamba2_decode(cfg: ArchConfig, params: Params, cache: Dict,
                  batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode; the cache passed in is updated in place."""
    mcfg = mamba_config(cfg)
    mc, ac = cache["mamba"], cache["attn"]
    x = _embed(params, batch)
    news = []
    for i, sb in enumerate(params["supers"]):
        for j, lp in enumerate(sb):
            h, nc = mamba2_apply(lp["mamba"], mcfg, rms_norm(x, lp["ln"]),
                                 cache={k: v[i, j] for k, v in mc.items()})
            _write_layer(mc, (i, j), nc)
            x = x + h
        x, new_kv = _zamba_shared_apply(
            cfg, params["shared"], x, cache={k: v[i] for k, v in ac.items()})
        news.append(new_kv)
    # one in-place token-slot write for all shared-attn cache layers
    new_attn = update_stacked_cache(cfg, ac, stack_caches(news))
    mc = dict(mc, pos=mc["pos"] + 1)
    return _logits(params, x), {"mamba": mc, "attn": new_attn}


@torch.no_grad()
def zamba2_prefill(cfg: ArchConfig, params: Params, batch: Dict,
                   max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """The parallel form a layer, keeping each Mamba2 layer's final state
    and each superblock's K/V; the last position's logits (B, 1, V)."""
    mcfg = mamba_config(cfg)
    x = _embed(params, batch)
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"a prompt of {s} positions does not fit a cache "
                         f"of max_seq={max_seq}")
    n_super = cfg.n_layers // cfg.mamba_per_attn
    acache = new_cache(lambda dev: broadcast_cache(gqa_init_cache(
        attn_config(cfg), b, max_seq, x.dtype, dev), (n_super,)),
        b, max_seq, x.device)
    mstates = []
    for i, sb in enumerate(params["supers"]):
        row = []
        for lp in sb:
            h, mc = mamba2_apply(lp["mamba"], mcfg, rms_norm(x, lp["ln"]),
                                 with_state=True)
            row.append(mc)
            x = x + h
        mstates.append(stack_caches(row))
        x, kv = _zamba_shared_apply(cfg, params["shared"], x)
        for name, t in kv.items():
            acache[name][i, :, :s] = t
    acache["pos"].fill_(s)
    return _logits(params, x[:, -1:]), {"mamba": stack_caches(mstates),
                                        "attn": acache}


# =============================================================================
# xLSTM LM
# =============================================================================
def xlstm_config(cfg: ArchConfig) -> XLSTMConfig:
    return XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)


def xlstm_defs(cfg: ArchConfig) -> Dict[str, Any]:
    assert cfg.n_layers % 2 == 0
    xcfg = xlstm_config(cfg)
    pair = {
        "ln_m": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlstm": mlstm_defs(xcfg),
        "ln_s": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "slstm": slstm_defs(xcfg),
    }
    v = cfg.padded_vocab
    return {
        "embed": ParamDef((v, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "pairs": stack_defs(pair, cfg.n_layers // 2),
        "final_ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), ("embed", "vocab"), scale=0.02),
    }


def xlstm_loss(cfg: ArchConfig, params: Params, batch: Dict,
               remat: str = "nothing_saveable", loss_chunks: int = 1,
               **_) -> torch.Tensor:
    """The mean next-token cross-entropy, differentiable; any ``remat``
    but "none" recomputes each mLSTM/sLSTM pair in the backward pass, as
    the JAX package does."""
    policy = "none" if remat == "none" else "nothing_saveable"
    xcfg = xlstm_config(cfg)

    def pair(x, lp):
        h, _ = mlstm_apply(lp["mlstm"], xcfg, rms_norm(x, lp["ln_m"]))
        x = x + h
        h, _ = slstm_apply(lp["slstm"], xcfg, rms_norm(x, lp["ln_s"]))
        return shard_act(x + h, ("batch", None, None))

    x = shard_act(_embed(params, batch), ("batch", None, None))
    for lp in params["pairs"]:
        x = remat_apply(functools.partial(pair, lp=lp), policy, x)
    hidden = rms_norm(x, params["final_ln"])
    return cross_entropy_from_hidden(hidden, params["lm_head"],
                                     batch["labels"], seq_chunks=loss_chunks)


def xlstm_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                     device=None) -> Dict:
    """The states are fp32 whatever the model's dtype, as in JAX."""
    xcfg = xlstm_config(cfg)
    lead = (cfg.n_layers // 2,)
    return {"mlstm": broadcast_cache(mlstm_init_cache(xcfg, batch, device),
                                     lead),
            "slstm": broadcast_cache(slstm_init_cache(xcfg, batch, device),
                                     lead)}


@torch.no_grad()
def xlstm_decode(cfg: ArchConfig, params: Params, cache: Dict,
                 batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode; the cache passed in is updated in place."""
    xcfg = xlstm_config(cfg)
    x = _embed(params, batch)
    for i, lp in enumerate(params["pairs"]):
        for name, ln, apply in (("mlstm", "ln_m", mlstm_apply),
                                ("slstm", "ln_s", slstm_apply)):
            h, new = apply(lp[name], xcfg, rms_norm(x, lp[ln]),
                           cache={k: v[i] for k, v in cache[name].items()})
            _write_layer(cache[name], i, new)
            x = x + h
    out = {name: dict(c, pos=c["pos"] + 1) for name, c in cache.items()}
    return _logits(params, x), out


@torch.no_grad()
def xlstm_prefill(cfg: ArchConfig, params: Params, batch: Dict,
                  max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """The parallel mLSTM and the token-by-token sLSTM a layer, keeping
    each layer's final state; the last position's logits (B, 1, V).
    ``max_seq`` is not read: the states do not grow with the sequence."""
    xcfg = xlstm_config(cfg)
    x = _embed(params, batch)
    mstates, sstates = [], []
    for lp in params["pairs"]:
        h, mc = mlstm_apply(lp["mlstm"], xcfg, rms_norm(x, lp["ln_m"]),
                            with_state=True)
        mstates.append(mc)
        x = x + h
        h, sc = slstm_apply(lp["slstm"], xcfg, rms_norm(x, lp["ln_s"]),
                            with_state=True)
        sstates.append(sc)
        x = x + h
    return _logits(params, x[:, -1:]), {"mlstm": stack_caches(mstates),
                                        "slstm": stack_caches(sstates)}
