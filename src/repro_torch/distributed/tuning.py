"""Closed-form architecture arithmetic of a model-zoo entry.

The JAX package's ``repro.distributed.tuning`` also holds the train-step
sharding problem (``ShardingProblem``); the port has only the parameter
counts so far, which the serving workload model needs
(``repro_torch.serve.autotune.stats_from_arch``).  The sharding problem
waits for ROADMAP.md, queue 1, item 9.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig


def arch_param_count(cfg: ArchConfig) -> float:
    """Closed-form parameter count of a model-zoo entry (all experts)."""
    q = cfg.n_heads * cfg.eff_head_dim
    kv = cfg.n_kv_heads * cfg.eff_head_dim
    attn = cfg.d_model * q + 2.0 * cfg.d_model * kv + q * cfg.d_model
    d_ff = cfg.moe_d_ff or cfg.d_ff
    if cfg.n_experts > 0:
        mlp = (cfg.n_experts + cfg.n_shared_experts) * 3.0 * cfg.d_model \
            * d_ff + cfg.d_model * cfg.n_experts  # router
    else:
        mlp = 3.0 * cfg.d_model * cfg.d_ff
    norms = 2.0 * cfg.d_model
    embed = cfg.padded_vocab * cfg.d_model \
        * (1.0 if cfg.tie_embeddings else 2.0)
    return cfg.n_layers * (attn + mlp + norms) + embed + cfg.d_model


def arch_active_param_count(cfg: ArchConfig) -> float:
    """Parameters a token actually touches (MoE: ``top_k`` experts)."""
    if cfg.n_experts <= 0:
        return arch_param_count(cfg)
    active = cfg.scaled(n_experts=max(1, cfg.top_k))
    return arch_param_count(active)
