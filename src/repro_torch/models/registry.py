"""Model registry: ArchConfig -> Model (init / loss / prefill / decode /
init_cache / parameter counts).

The JAX package's ``repro.models.registry``, for all four families of the
model zoo: the transformer LMs (dense, MoE, MLA, the VLM stub), Zamba2 and
xLSTM (``hybrid``), and the encoder-decoder (``encdec``), dispatched by the
config's fields as the JAX registry dispatches them.  ``Model.init`` draws
the parameters on a device (the card unless the caller names the CPU) from
an explicit ``torch.Generator`` and returns them as a ``ParamTree``
module; ``prefill``, ``decode`` and ``loss`` take that module where the
JAX functions take their nested dicts.  ``specs`` gives the ParamDefs'
logical axes in the JAX layout (stacked leaves with their ``layers``
axes), ``named_specs`` the same for each parameter of the module (one a
layer); the sharded train step lays the parameters out by them.

The dry run's abstract trees hold ``meta`` tensors, the counterpart of
JAX's ``ShapeDtypeStruct``: a shape and a dtype, no storage.
``abstract`` and ``cache_specs`` follow the JAX layout (stacked leaves
with their ``layers`` axes), ``input_specs`` gives every model input of a
``ShapeConfig``, and ``abstract_module`` the parameters as a ``ParamTree``
of meta tensors, the module the step takes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.common import (ParamDef, ParamTree, abstract_params,
                                       init_leaf, logical_specs)
from repro_torch.models.config import ArchConfig, ShapeConfig

META = torch.device("meta")

# the subtrees stacked along a layers axis, split into one module a layer
STACKED = ("blocks", "supers", "pairs", "enc", "dec")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _family(cfg: ArchConfig):
    """The arch's family's (loss, prefill, decode, init_cache)."""
    if cfg.xlstm:
        return (hybrid.xlstm_loss, hybrid.xlstm_prefill, hybrid.xlstm_decode,
                hybrid.xlstm_init_cache)
    if cfg.mamba_per_attn:
        return (hybrid.zamba2_loss, hybrid.zamba2_prefill,
                hybrid.zamba2_decode, hybrid.zamba2_init_cache)
    if cfg.enc_layers:
        return (encdec.encdec_loss, encdec.encdec_prefill,
                encdec.encdec_decode, encdec.encdec_init_cache)
    return (transformer.lm_loss, transformer.prefill, transformer.decode_step,
            transformer.init_cache)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    defs: Any

    # --- parameters -----------------------------------------------------------
    def module(self, leaf: Callable) -> ParamTree:
        """The parameters as a module, ``leaf(path, ParamDef)`` making each
        tensor (a stacked leaf whole, with its layers axes)."""
        return ParamTree(self.defs, leaf, stacked=STACKED)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ParamTree:
        """The parameters on ``device`` (default: the card), drawn from
        ``generator`` (default: seed 0 on that device) as the JAX package
        draws them: the same distributions, not the same bits."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dt = model_dtype(self.cfg)
        return self.module(lambda path, d: init_leaf(d, generator, dt, dev))

    def abstract(self):
        """The parameters' shapes and dtype as a tree of meta tensors, the
        JAX layout (stacked leaves whole); nothing is allocated."""
        return abstract_params(self.defs, model_dtype(self.cfg))

    def abstract_module(self) -> ParamTree:
        """The parameters as a ``ParamTree`` of meta tensors."""
        dt = model_dtype(self.cfg)
        return self.module(
            lambda path, d: torch.empty(d.shape, dtype=dt, device=META))

    def specs(self):
        """The logical-axis tree of the parameters, the JAX layout."""
        return logical_specs(self.defs)

    def named_specs(self):
        """Module parameter name -> its logical axes (a stacked leaf's
        layers axes dropped: the module holds one tensor a layer)."""
        out = {}
        for name, _ in self.abstract_module().named_parameters():
            parts = name.split(".")
            keys = [k for k in parts if not k.isdigit()]
            d = self.defs
            for k in keys:
                d = d[k]
            assert isinstance(d, ParamDef), name
            out[name] = d.spec[len(parts) - len(keys):]
        return out

    # --- compute --------------------------------------------------------------
    def loss(self, params, batch, **opts) -> torch.Tensor:
        return _family(self.cfg)[0](self.cfg, params, batch, **opts)

    def prefill(self, params, batch, max_seq: int):
        return _family(self.cfg)[1](self.cfg, params, batch, max_seq)

    def decode(self, params, cache, batch):
        return _family(self.cfg)[2](self.cfg, params, cache, batch)

    def init_cache(self, batch: int, max_seq: int, device=None):
        return _family(self.cfg)[3](self.cfg, batch, max_seq,
                                    model_dtype(self.cfg),
                                    resolve_device(device))

    def cache_specs(self, batch: int, max_seq: int):
        """``init_cache``'s tree as meta tensors."""
        return _family(self.cfg)[3](self.cfg, batch, max_seq,
                                    model_dtype(self.cfg), META)

    # --- dry-run inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig):
        """Meta stand-ins for every model input of ``shape``: int32 tokens
        (and labels to train), the frontend's fp32 embeddings; a vision
        prefix counts toward a prefill's sequence, as in JAX."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=META)

        if shape.kind == "train":
            specs = {"tokens": spec((b, s), torch.int32),
                     "labels": spec((b, s), torch.int32)}
        elif shape.kind == "prefill":
            s_text = s - (cfg.frontend_len if cfg.frontend == "vision" else 0)
            specs = {"tokens": spec((b, s_text), torch.int32)}
        else:  # decode: one new token against a cache of length s
            specs = {"tokens": spec((b, 1), torch.int32)}
        if shape.kind != "decode":
            if cfg.frontend == "vision":
                specs["patch_embeds"] = spec(
                    (b, cfg.frontend_len, cfg.frontend_dim), torch.float32)
            if cfg.frontend == "audio":
                specs["frames"] = spec(
                    (b, cfg.frontend_len, cfg.frontend_dim), torch.float32)
        return specs

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
    if cfg.xlstm:
        defs = hybrid.xlstm_defs(cfg)
    elif cfg.mamba_per_attn:
        defs = hybrid.zamba2_defs(cfg)
    elif cfg.enc_layers:
        defs = encdec.encdec_defs(cfg)
    else:
        defs = transformer.lm_defs(cfg)
    return Model(cfg=cfg, defs=defs)
