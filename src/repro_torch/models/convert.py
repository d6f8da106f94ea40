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

``train_state_from_jax(cfg, state)`` carries a JAX ``TrainState`` (params,
AdamW moments, count, step) into the port's, trainable, keyed as the
checkpointer keys a checkpoint's leaves
(``repro_torch.checkpoint.checkpointer.leaf_key``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import load_arrays
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import TrainState


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


def _flatten(tree, prefix=()):
    """``(key, leaf)`` of a JAX state as the JAX checkpointer flattens it:
    dicts in sorted key order, named tuples by field, "/"-joined."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if hasattr(tree, "_fields"):
        return [kv for k in tree._fields
                for kv in _flatten(getattr(tree, k), prefix + (k,))]
    return [("/".join(prefix), tree)]


def train_state_from_jax(cfg: ArchConfig, state, device=None):
    """The JAX package's ``TrainState`` as the port's: the params through
    ``params_from_jax`` (made trainable), the fp32 moments, the count and
    the step, each leaf placed by the checkpointer's key mapping."""
    params = params_from_jax(cfg, state.params, device).requires_grad_()
    opt = AdamW.init(dict(params.named_parameters()))
    template = TrainState(params=params, opt=opt, step=opt.count.clone())
    return load_arrays(template, {k: np.asarray(v)
                                  for k, v in _flatten(state)})
