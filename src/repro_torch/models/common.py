"""Model substrate: parameter definitions, norms, linear layers, RoPE, the
gated MLP and the cross-entropy, in PyTorch.

The JAX package's ``repro.models.common`` carried over function for
function.  Every leaf is declared by a ``ParamDef`` (shape, logical axes,
initializer), and ``init_params`` draws each leaf from the same
distribution as the JAX package (normal with the fan-in or the declared
scale as its standard deviation, zeros, ones) from an explicit
``torch.Generator`` on an explicit device.  It follows the distributions,
not the bits: weights are carried from the JAX package with
``repro_torch.models.convert.params_from_jax``.

``dense`` is a ``torch.matmul``: the JAX package computes its products in
plain JAX, outside any Pallas kernel.  The numerics follow the JAX
functions: norms in fp32, cast back to the input's dtype; RoPE angles in
fp32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.api import call_local, shard_act

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default fan-in

    def __post_init__(self):
        assert len(self.shape) == len(self.spec), (self.shape, self.spec)


def _tree_map_defs(fn: Callable, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _tree_map_defs(fn, v) for k, v in defs.items()}


def abstract_params(defs, dtype: torch.dtype):
    """ParamDef tree -> tree of meta tensors (the dry run; no storage)."""
    return _tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def logical_specs(defs):
    """ParamDef tree -> tree of logical-axis tuples (mirrors init_params)."""
    return _tree_map_defs(lambda d: d.spec, defs)


def stack_defs(defs, n: int):
    """Prepend a layers axis to every leaf (the JAX package scans over it;
    the port keeps one module a layer and draws each stacked leaf whole)."""
    return _tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.spec, d.init,
                           d.scale),
        defs,
    )


def param_leaves(defs, path: Tuple[str, ...] = ()):
    """``(path, ParamDef)`` of every leaf, in the sorted-path order the
    JAX package's ``init_params`` draws them in."""
    if isinstance(defs, ParamDef):
        return [(path, defs)]
    out = []
    for k in sorted(defs):
        out.extend(param_leaves(defs[k], path + (k,)))
    return out


def init_leaf(d: ParamDef, generator: torch.Generator,
              dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One leaf drawn as the JAX package draws it: zeros, ones, or a
    normal in fp32 times the scale (default 1/sqrt(fan-in)), cast."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    arr = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                      device=device)
    return arr.mul_(std).to(dtype)


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Params:
    """Materialize a ParamDef tree as nested dicts of tensors on
    ``device``; ``generator`` must lie on that device."""
    device = torch.device("cpu") if device is None else torch.device(device)
    out: Params = {}
    for path, d in param_leaves(defs):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = init_leaf(d, generator, dtype, device)
    return out


# =============================================================================
# Elementary layers
# =============================================================================
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * gamma + beta).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (V, D) at ``tokens``.  Under a mesh the table is
    gathered whole on every rank first and each rank looks up its own
    tokens (``call_local``), its gradient reduced onto the table's layout
    afterwards: DTensor's lookup is wrong for a table split on both dims
    (ROADMAP.md, queue 3), and torch 2.11's rules for indexing take
    neither a batch split over two mesh axes nor the backward of a lookup
    in a replicated table."""
    return call_local(_lookup, (table, tokens),
                      ((None, None), ("batch", None)), ("batch", None, None))


def _lookup(table: torch.Tensor, tokens: torch.Tensor,
            offsets) -> torch.Tensor:
    return table[tokens.long()]


# --- rotary position embeddings ----------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integers."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                   # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# --- gated MLPs ----------------------------------------------------------------
def mlp_defs(d_model: int, d_ff: int, gated: bool = True) -> Dict[str, ParamDef]:
    defs = {
        "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), ("embed", "mlp"))
    return defs


# jax.nn.gelu defaults to the tanh approximation
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
    "relu": F.relu,
}


def mlp_apply(p: Params, x: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    up = dense(x, p["w_up"])
    if "w_gate" in p:
        up = act(dense(x, p["w_gate"])) * up
    else:
        up = act(up)
    return dense(up, p["w_down"])


# =============================================================================
# Rematerialization
# =============================================================================
# the JAX package's jax.checkpoint policies that save some values: the
# outputs of its dots (dot_general), all of them or those without batch
# dimensions; PyTorch's GEMMs are mm/addmm (2-D) and bmm (batched)
_SAVED_OPS = {
    "dots_saveable": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims": (torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default),
}
REMAT_POLICIES = ("none", "nothing_saveable") + tuple(_SAVED_OPS)


def _save_ops(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_apply(fn: Callable, policy: str, *args):
    """``fn(*args)`` under one of the JAX package's remat policies: "none"
    keeps every activation for the backward pass; "nothing_saveable"
    keeps only the inputs and recomputes ``fn`` in the backward pass;
    "dots_saveable" and "dots_with_no_batch_dims" keep the GEMMs' outputs
    (all of them, or the unbatched ones) and recompute the rest."""
    if policy == "none":
        return fn(*args)
    if policy == "nothing_saveable":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")
    ctx = functools.partial(create_selective_checkpoint_contexts,
                            functools.partial(_save_ops, _SAVED_OPS[policy]))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)


# =============================================================================
# Caches stacked along the layers
# =============================================================================
def broadcast_cache(tree: Dict, lead: Tuple[int, ...]) -> Dict:
    """Every leaf of a one-layer cache repeated along leading ``lead``
    axes (``pos`` too), each a tensor of its own."""
    return {k: broadcast_cache(v, lead) if isinstance(v, dict)
            else v.expand(lead + tuple(v.shape)).clone()
            for k, v in tree.items()}


def stack_caches(caches: List[Dict]) -> Dict:
    """One-layer caches stacked along a new leading axis, key by key."""
    return {k: stack_caches([c[k] for c in caches])
            if isinstance(caches[0][k], dict)
            else torch.stack([c[k] for c in caches])
            for k in caches[0]}


# =============================================================================
# Loss: cross-entropy, optionally chunked along the sequence
# =============================================================================
def _chunk_ce(hidden: torch.Tensor, w_out: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(hidden, w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - _gold(logits, labels)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit at its label.  Where the vocab dim is split
    over a mesh axis, DTensor's ``gather`` along it is wrong (ROADMAP.md,
    queue 3); the masked sum over the vocab picks the same value, exactly
    (one term and zeros), each rank over its own slice."""
    if not (isinstance(logits, DTensor) and any(
            isinstance(p, Shard) and p.dim == logits.dim() - 1
            for p in logits.placements)):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ids = torch.arange(logits.shape[-1], device=labels.device)
    return torch.where(ids == labels[..., None].long(), logits, 0.0).sum(-1)


def cross_entropy_from_hidden(
    hidden: torch.Tensor,     # (B, S, D)
    w_out: torch.Tensor,      # (D, V)
    labels: torch.Tensor,     # (B, S) integers
    seq_chunks: int = 1,
) -> torch.Tensor:
    b, s, _ = hidden.shape
    if seq_chunks <= 1:
        return torch.mean(_chunk_ce(hidden, w_out, labels))
    assert s % seq_chunks == 0, (s, seq_chunks)
    cs = s // seq_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(seq_chunks):
        total = total + torch.sum(_chunk_ce(
            hidden[:, c * cs:(c + 1) * cs], w_out,
            labels[:, c * cs:(c + 1) * cs]))
    return total / (b * s)


# =============================================================================
# Parameters as modules
# =============================================================================
class ParamTree(torch.nn.Module):
    """A ParamDef tree as a module: a leaf is a parameter (frozen, as
    serving takes it; ``requires_grad_()`` makes every leaf trainable, as
    ``repro_torch.train.train_step.init_train_state`` does), a subtree a
    child module, and a stacked subtree (``layers`` leading axis) a
    ``ModuleList`` of one tree a layer; a subtree stacked twice (Zamba2's
    superblocks of layers) a ``ModuleList`` of ``ModuleList``s.
    ``p["wq"]``, ``p.get("bq")`` and ``"w_gate" in p`` read it as the JAX
    package's functions read their nested dicts.

    ``leaf(path, ParamDef)`` makes each tensor, stacked leaves whole;
    ``stacked`` names the subtrees split into layers."""

    def __init__(self, defs, leaf: Callable, path: Tuple[str, ...] = (),
                 stacked: Tuple[str, ...] = ()):
        super().__init__()
        self._keys = tuple(sorted(defs))
        for k in self._keys:
            d = defs[k]
            if isinstance(d, ParamDef):
                self.register_parameter(k, torch.nn.Parameter(
                    leaf(path + (k,), d), requires_grad=False))
            elif k in stacked:
                self.add_module(k, _split_layers(d, leaf, path + (k,)))
            else:
                self.add_module(k, ParamTree(d, leaf, path + (k,)))

    def __getitem__(self, k: str):
        if k not in self._keys:
            raise KeyError(k)
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._keys

    def get(self, k: str, default=None):
        return self[k] if k in self._keys else default


def _split_layers(defs, leaf: Callable, path: Tuple[str, ...]
                  ) -> torch.nn.ModuleList:
    """A stacked subtree as one ParamTree a layer (a ModuleList of them
    for each further ``layers`` axis), each stacked leaf made whole (one
    draw, as the JAX package draws it) and sliced."""
    leaves = param_leaves(defs)
    whole = {p: leaf(path + p, d) for p, d in leaves}
    spec, depth = leaves[0][1].spec, 0
    while depth < len(spec) and spec[depth] == "layers":
        depth += 1
    return _layers_of(defs, whole, depth)


def _layers_of(defs, whole: Dict, depth: int) -> torch.nn.ModuleList:
    n = next(iter(whole.values())).shape[0]
    inner = _tree_map_defs(
        lambda d: ParamDef(d.shape[1:], d.spec[1:], d.init, d.scale), defs)
    if depth > 1:
        return torch.nn.ModuleList(
            _layers_of(inner, {p: t[i] for p, t in whole.items()}, depth - 1)
            for i in range(n))
    return torch.nn.ModuleList(
        ParamTree(inner, lambda p, d, i=i: whole[p][i]) for i in range(n))
