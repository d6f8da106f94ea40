"""Carry the JAX package's model parameters into the port.

``params_from_jax(cfg, tree)`` takes the JAX params of any model-zoo arch
(nested dicts of arrays, layers stacked on leading axes: ``blocks``,
Zamba2's ``supers`` (n_super, per) and ``shared``, xLSTM's ``pairs``, the
encoder-decoder's ``enc``, ``dec`` with its ``xattn`` and
``frontend_proj``; anything ``numpy.asarray`` reads, jax arrays included)
and returns the port's module holding the same numbers, so that the port
computes what the JAX package computes on the same weights.  Every leaf's
shape is checked against the port's definition.  The module lies on the
CPU unless ``device`` says otherwise; a bf16 leaf stays bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ParamTree
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_model


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":   # numpy has no bf16: go through fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(cfg: ArchConfig, tree, device=None) -> ParamTree:
    def leaf(path, d):
        node = tree
        for p in path:
            node = node[p]
        t = _tensor(node)
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape "
                             f"{tuple(t.shape)}, port shape {d.shape}")
        return t if device is None else t.to(device)

    return build_model(cfg).module(leaf)
