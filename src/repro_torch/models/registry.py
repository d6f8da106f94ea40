"""Model registry: ArchConfig -> Model (init / loss / prefill / decode /
init_cache / parameter counts).

The JAX package's ``repro.models.registry`` for the transformer families.
``Model.init`` draws the parameters on a device (the card unless the
caller names the CPU) from an explicit ``torch.Generator`` and returns
them as a ``TransformerLM`` module; ``prefill``, ``decode`` and ``loss``
take that module where the JAX functions take their nested dicts.  The
dry-run specs (``abstract``, ``specs``, ``cache_specs``, ``input_specs``)
wait for ROADMAP.md, queue 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import init_leaf
from repro_torch.models.config import ArchConfig

NOT_PORTED = ("the {what} family is not ported yet: the port has the "
              "transformer families (dense, moe, vlm); ssm, xlstm, hybrid "
              "and encoder-decoder models wait for ROADMAP.md, queue 1, "
              "item 7")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    defs: Any

    # --- parameters -----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> transformer.TransformerLM:
        """The parameters on ``device`` (default: the card), drawn from
        ``generator`` (default: seed 0 on that device) as the JAX package
        draws them: the same distributions, not the same bits."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dt = model_dtype(self.cfg)
        return transformer.TransformerLM(
            self.cfg, lambda path, d: init_leaf(d, generator, dt, dev))

    # --- compute --------------------------------------------------------------
    def loss(self, params, batch, **opts) -> torch.Tensor:
        return transformer.lm_loss(self.cfg, params, batch, **opts)

    def prefill(self, params, batch, max_seq: int):
        return transformer.prefill(self.cfg, params, batch, max_seq)

    def decode(self, params, cache, batch):
        return transformer.decode_step(self.cfg, params, cache, batch)

    def init_cache(self, batch: int, max_seq: int, device=None):
        return transformer.init_cache(self.cfg, batch, max_seq,
                                      model_dtype(self.cfg),
                                      resolve_device(device))

    # --- bookkeeping ------------------------------------------------------------
    def param_count(self) -> int:
        total = 0

        def walk(d):
            nonlocal total
            if hasattr(d, "shape"):
                n = 1
                for x in d.shape:
                    n *= x
                total += n
            else:
                for v in d.values():
                    walk(v)

        walk(self.defs)
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (shared + top_k of routed)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        f = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * f
        routed_all = cfg.n_layers * cfg.n_experts * per_expert
        routed_active = cfg.n_layers * cfg.top_k * per_expert
        return total - routed_all + routed_active


def build_model(cfg: ArchConfig) -> Model:
    for what, has in (("xlstm", cfg.xlstm), ("zamba2 hybrid",
                                             cfg.mamba_per_attn),
                      ("encoder-decoder", cfg.enc_layers)):
        if has:
            raise NotImplementedError(
                f"{cfg.name}: {NOT_PORTED.format(what=what)}")
    return Model(cfg=cfg, defs=transformer.lm_defs(cfg))
