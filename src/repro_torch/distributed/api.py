"""Activation-sharding context: the JAX package's
``repro.distributed.api`` carried over.  Models annotate activations with
logical axes; the distributed runtime installs a resolver mapping them to
mesh axes (``repro_torch.distributed.sharding.make_act_resolver``).

Outside a mesh context ``shard_act`` is the identity and ``call_local``
calls its function, so models run unchanged on one device (the plain
step, serving).  Inside one, ``shard_act`` redistributes a ``DTensor`` to
the placements the logical axes resolve to (the JAX package's
``with_sharding_constraint``), and ``call_local`` runs a function on each
rank's local shards: the hand-written kernels (ctypes launches) and the
bit-level helpers take plain tensors, never a ``DTensor``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

_state = threading.local()


def _resolver() -> Optional[Callable]:
    return getattr(_state, "resolver", None)


def shard_act(x: torch.Tensor,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Constrain activation sharding by logical axis names (or no-op)."""
    fn = _resolver()
    if fn is None:
        return x
    return fn(x, tuple(logical))


def call_local(fn: Callable, args: Sequence[torch.Tensor],
               in_logical: Sequence[Sequence[Optional[str]]],
               out_logical: Sequence[Optional[str]], **kwargs):
    """``fn(*args, offsets=..., **kwargs)`` on local tensors.

    Outside a mesh: ``offsets`` is a tuple of zeros, one tuple per arg
    (each dim starts at 0).  Inside one: each arg is redistributed to the
    placements of its logical axes, ``fn`` sees every rank's local shard
    and the global start of each of its dims in ``offsets``, and its
    output is taken as laid out by ``out_logical`` (a tuple of them for a
    tuple of outputs)."""
    fn_r = _resolver()
    if fn_r is None:
        if any(hasattr(a, "placements") for a in args):
            raise RuntimeError(
                "call_local got a DTensor outside activation_sharding: a "
                "kernel takes each rank's local shard")
        return fn(*args, offsets=tuple((0,) * a.dim() for a in args),
                  **kwargs)
    return fn_r.local(fn, args, in_logical, out_logical, **kwargs)


def split_heads(x: torch.Tensor, n: int, d: int,
                logical: Optional[str]) -> torch.Tensor:
    """``x`` (..., n*d) as (..., n, d), n heads of ``logical`` axis.
    Under a mesh its last dim is laid out first as the heads can be split
    (whole heads a rank, or every rank all of them where n does not divide
    the axis): DTensor cannot split a dim that is split mid-head."""
    fn = _resolver()
    if fn is not None:
        x = fn.split_heads(x, n, d, logical)
    return x.reshape(tuple(x.shape[:-1]) + (n, d))


def local_op(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that acts within each shard (elementwise,
    or a pad of a dim no mesh axis splits) where DTensor has no sharding
    rule (``F.logsigmoid``'s backward) or a wrong one (``F.pad`` on a
    two-axis mesh loses an axis in torch 2.11): on a ``DTensor``, ``fn``
    of each rank's local shard, laid out as ``x`` (a partial sum reduced
    first)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def index_copy_(buf: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``buf.index_copy_(dim, index, src)``.  On a ``DTensor`` whose
    ``dim`` no mesh axis splits, on each rank's local shards (``src`` laid
    out as ``buf`` first, ``index`` whole): torch 2.11's DTensor has no
    rule for ``index_copy_``."""
    return _index_local("index_copy_", buf, dim, index, src)


def index_add_(buf: torch.Tensor, dim: int, index: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``buf.index_add_(dim, index, src)``, on local shards as
    ``index_copy_`` is: torch 2.11's DTensor has no rule for
    ``index_add_``."""
    return _index_local("index_add_", buf, dim, index, src)


def _index_local(op: str, buf: torch.Tensor, dim: int, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor) or any(
            isinstance(p, Shard) and p.dim % buf.dim() == dim % buf.dim()
            for p in buf.placements):
        return getattr(buf, op)(dim, index, src)
    mesh = buf.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, buf.placements)
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, [Replicate()] * mesh.ndim) \
            ._local_tensor
    getattr(buf._local_tensor, op)(dim, index, src._local_tensor)
    return buf


def new_cache(init: Callable, batch: int, max_seq: int,
              device) -> dict:
    """The cache tree ``init(device)`` makes (zeros).  Inside a mesh each
    leaf is a ``DTensor`` laid out as ``sharding.cache_shardings`` lays out
    a cache, made from this rank's block alone: no rank holds the whole
    cache."""
    fn = _resolver()
    if fn is None:
        return init(device)
    return fn.new_cache(init(torch.device("meta")), batch, max_seq, device)


@contextlib.contextmanager
def activation_sharding(resolver: Callable):
    """Install a resolver: (array, logical axes) -> array, and the context
    it runs under (``resolver.context()``, where it has one)."""
    prev = _resolver()
    _state.resolver = resolver
    try:
        with (resolver.context() if hasattr(resolver, "context")
              else contextlib.nullcontext()):
            yield
    finally:
        _state.resolver = prev
