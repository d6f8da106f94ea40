"""Torch 2.11's DTensor gaps, put into torch 2.13 for a test.

The card's machine runs torch 2.11, whose DTensor refuses two things that
torch 2.13's takes: a strict view (``view``, ``_unsafe_view``: an einsum's
or a matmul's internal reshapes) that flattens a dim split over a mesh
axis unless that dim leads the flattened ones ("Attempted to flatten
multiple dimensions, with dimension 1 being sharded"), and
``index_add_``, for which it has no sharding strategy (2.13 derives one
from its decomposition).  ``torch_211_gaps()`` makes 2.13 refuse both, with
2.11's messages, so that the dry run's cells can be held to the card's
torch on the CPU (``tests/test_torch_dryrun.py``); the card's torch itself
is ``tests/test_torch_gpu.py``'s.
"""
import contextlib

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor import _sharding_prop
from torch.distributed.tensor._ops import _view_ops

aten = torch.ops.aten
NO_STRATEGY = (aten.index_add_.default, aten.index_add.default)


def _input_dims(spec):
    if isinstance(spec, _view_ops.InputDim):
        return [spec.input_dim]
    if isinstance(spec, _view_ops.Flatten):
        return [d for s in spec.input_dims for d in _input_dims(s)]
    return []


@contextlib.contextmanager
def torch_211_gaps():
    """Within: strict views may not flatten a split dim that does not lead
    the flattened ones, and ``index_add_`` has no strategy.  DTensor's
    cache of strategies is emptied on entry and on exit."""
    propagate_view = _view_ops.propagate_shape_and_sharding
    propagate_op = _sharding_prop.ShardingPropagator \
        .propagate_op_sharding_non_cached

    def view_211(placements, shape, rule, mesh_sizes, strict_view=False):
        for spec in rule if strict_view else ():
            if not isinstance(spec, _view_ops.Flatten):
                continue
            for d in _input_dims(spec)[1:]:
                if any(type(p) is Shard and p.dim == d for p in placements):
                    raise RuntimeError(
                        "Attempted to flatten multiple dimensions, with "
                        f"dimension {d} being sharded (torch 2.11)")
        return propagate_view(placements, shape, rule, mesh_sizes,
                              strict_view)

    def op_211(self, op_schema):
        if op_schema.op in NO_STRATEGY:
            raise NotImplementedError(
                f"Operator {op_schema.op} does not have a sharding strategy "
                "registered (torch 2.11)")
        return propagate_op(self, op_schema)

    cache = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
    _view_ops.propagate_shape_and_sharding = view_211
    _sharding_prop.ShardingPropagator.propagate_op_sharding_non_cached = \
        op_211
    cache.cache_clear()
    try:
        yield
    finally:
        _view_ops.propagate_shape_and_sharding = propagate_view
        _sharding_prop.ShardingPropagator \
            .propagate_op_sharding_non_cached = propagate_op
        cache.cache_clear()
