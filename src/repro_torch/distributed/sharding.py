"""Logical-axis → mesh-axis sharding rules (FSDP × TP × EP × SP): the JAX
package's ``repro.distributed.sharding`` carried over onto
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``.

Params carry logical axes from their ParamDefs; activations carry logical
axes at ``shard_act`` call sites.  Rules map logical names to mesh axes; a
dimension whose size does not divide the mesh-axis extent is replicated
(e.g. 8 KV heads on a 16-way model axis), no mesh axis shards two dims of
one tensor, and trailing unsharded dims are dropped from the spec, as in
JAX.  A spec is a tuple of per-dim entries (``None``, an axis name, or a
tuple of axis names), equal entry for entry to the JAX ``PartitionSpec``;
``placements_for`` turns it into DTensor placements: a dim over two axes
(``("pod", "data")``) is ``Shard(d)`` on both mesh dims, which DTensor
splits in mesh-dim order, JAX's major-to-minor order when the axes are
listed in the mesh's order (the only order this module produces).

``spec_for`` and the ``*_shardings`` functions take any mesh with named
axes: a ``DeviceMesh`` (``mesh_dim_names`` and ``shape``) or an object
whose ``.shape`` maps axis names to extents (the tests' stand-in for a
production mesh, nothing allocated).
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> mesh axis (or tuple of axes) mapping."""

    rules: Tuple[Tuple[str, Any], ...]

    def get(self, name: Optional[str]):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(tuple(d.items()))


def default_rules(multi_pod: bool, fsdp: bool = True,
                  tp: bool = True) -> ShardingRules:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    model = "model" if tp else None
    return ShardingRules(tuple({
        "batch": batch_axes,
        "vocab": model,
        "heads": model,
        "kv": model,
        "mlp": model,
        "expert": model,
        "embed": "data" if fsdp else None,   # FSDP: shard params over data
        "seq": "data",                        # SP for long-context cells
        "layers": None,
    }.items()))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> extent, in the mesh's axis order."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def spec_for(mesh, rules: ShardingRules,
             logical: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
    """A spec, dropping axes that do not divide evenly."""
    names = mesh_shape(mesh)
    parts = []
    used: set = set()
    for name, dim in zip(logical, shape):
        axes = rules.get(name)
        if axes is None:
            parts.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in names and a not in used)
        size = _axis_size(mesh, axes)
        if size <= 1 or dim % size != 0:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(mesh, spec: Spec) -> Tuple:
    """DTensor placements of a spec, one per mesh axis: ``Shard(d)`` on
    every axis that shards dim ``d``, ``Replicate()`` elsewhere."""
    order = list(mesh_shape(mesh))
    out = [Replicate()] * len(order)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {d} is sharded over {axes}, not in the mesh's axis "
                f"order {tuple(order)}: DTensor splits a dim in mesh order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A tensor's place on a mesh: the JAX ``NamedSharding``'s analog."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return placements_for(self.mesh, self.spec)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def _tree_map(fn: Callable, tree, *rest, is_leaf=None):
    if isinstance(tree, Mapping) and not (is_leaf and is_leaf(tree)):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest),
                             is_leaf=is_leaf) for k in tree}
    return fn(tree, *rest)


def param_shardings(mesh, rules: ShardingRules, specs_tree, abstract_tree):
    """Logical-spec tree + shape tree (leaves with ``.shape``) -> Layout
    tree."""
    return _tree_map(
        lambda spec, ab: Layout(mesh, spec_for(mesh, rules, spec, ab.shape)),
        specs_tree, abstract_tree, is_leaf=_is_spec)


def shard_params(params: torch.nn.Module, named_specs: Dict[str, Spec],
                 mesh, rules: ShardingRules) -> torch.nn.Module:
    """Each parameter of ``params`` replaced, in place, by a ``DTensor``
    laid out by its logical axes (``Model.named_specs``), keeping its
    ``requires_grad``.  Every rank must hold the same full values."""
    from torch.distributed.tensor import distribute_tensor

    for prefix, mod in params.named_modules():
        for k, p in list(mod._parameters.items()):
            name = f"{prefix}.{k}" if prefix else k
            pl = placements_for(mesh, spec_for(mesh, rules,
                                               named_specs[name], p.shape))
            mod._parameters[k] = torch.nn.Parameter(
                distribute_tensor(p.data, mesh, pl),
                requires_grad=p.requires_grad)
    return params


def _mesh_axes(mesh, rules: ShardingRules, logical, shape) -> Tuple:
    """Per dim: the mesh axes that shard it (a tuple, maybe empty)."""
    spec = spec_for(mesh, rules, logical, shape)
    out = []
    for d in range(len(shape)):
        e = spec[d] if d < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


class ActResolver:
    """The resolver ``activation_sharding`` installs: ``shard_act``
    redistributes to the placements of the logical axes; ``local`` runs a
    function on the local shards (``api.call_local``)."""

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh = mesh
        self.rules = rules
        self._order = list(mesh_shape(mesh))

    @contextlib.contextmanager
    def context(self):
        """What the sharded step runs under, beside the resolver: plain
        tensors made inside the model (positions, masks, the vocab ids)
        taken as every rank's same value, the previous setting restored on
        exit (the public ``implicit_replication`` resets it to off); and
        the backward pass on the calling thread.  Both the resolver and
        that setting are the thread's own, and the autograd engine would
        run a card's backward pass, remat recomputes included, on a thread
        of its own."""
        disp = DTensor._op_dispatcher
        prev = disp._allow_implicit_replication
        disp._allow_implicit_replication = True
        try:
            with torch.autograd.set_multithreading_enabled(False):
                yield
        finally:
            disp._allow_implicit_replication = prev

    def _dtensor(self, x: torch.Tensor) -> DTensor:
        # a plain tensor inside the mesh is every rank's same value
        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, self.mesh,
                                  [Replicate()] * len(self._order),
                                  run_check=False)

    def __call__(self, x: torch.Tensor, logical) -> torch.Tensor:
        if len(logical) != x.dim():
            return x
        x = self._dtensor(x)
        target = placements_for(
            self.mesh, spec_for(self.mesh, self.rules, logical, x.shape))
        if tuple(x.placements) == target:
            return x
        return x.redistribute(self.mesh, target)

    def split_heads(self, x: torch.Tensor, n: int, d: int,
                    logical: Optional[str]) -> torch.Tensor:
        """``x`` (B, S, n*d) redistributed so that its last dim is split
        as the heads of (B, S, n, d) are (``api.split_heads``)."""
        x = self._dtensor(x)
        names = ("batch",) + (None,) * (x.dim() - 2)
        axes = _mesh_axes(self.mesh, self.rules, names + (logical, None),
                          tuple(x.shape[:-1]) + (n, d))
        target = placements_for(self.mesh, _spec_of(axes[:-1]))
        if tuple(x.placements) == target:
            return x
        last = x.dim() - 1
        if any(isinstance(p, Shard) and p.dim == last for p in x.placements) \
                and not any(isinstance(p, Shard) and p.dim == last
                            for p in target):
            # DTensor cannot split a dim split mid-head: gathered, GSPMD's
            # "involuntary full rematerialization"
            warnings.warn(f"split_heads: {n} {logical} heads do not divide "
                          "their mesh axes; their projection is gathered on "
                          "every rank", stacklevel=3)
        return x.redistribute(self.mesh, target)

    def new_cache(self, meta_tree, batch: int, max_seq: int, device):
        """``api.new_cache`` under this mesh: each meta leaf as a
        ``DTensor`` of zeros laid out by ``cache_shardings``."""
        layouts = cache_shardings(self.mesh, self.rules, meta_tree, batch,
                                  max_seq)

        def one(t, lay):
            block = local_slices(self.mesh, lay.spec, tuple(t.shape))
            local = torch.zeros(tuple(s.stop - s.start for s in block),
                                dtype=t.dtype, device=device)
            return DTensor.from_local(local, self.mesh, lay.placements,
                                      run_check=False,
                                      shape=tuple(t.shape),
                                      stride=tuple(t.stride()))

        return _tree_map(one, meta_tree, layouts)

    def local(self, fn: Callable, args, in_logical, out_logical, **kwargs):
        by_name: Dict[str, Tuple] = {}
        prepared = []
        for x, logical in zip(args, in_logical):
            x = self._dtensor(x)
            axes = _mesh_axes(self.mesh, self.rules, logical, x.shape)
            for name, ax in zip(logical, axes):
                if name is not None:
                    by_name.setdefault(name, ax)
            target = placements_for(self.mesh, _spec_of(axes))
            if tuple(x.placements) != target:
                x = x.redistribute(self.mesh, target)
            prepared.append((x, axes, target))
        several = bool(out_logical) and isinstance(out_logical[0],
                                                   (tuple, list))
        out_pls = [placements_for(self.mesh, _spec_of(tuple(
            by_name.get(n, ()) if n is not None else () for n in logical)))
            for logical in (out_logical if several else (out_logical,))]
        locals_, offsets = [], []
        for x, axes, target in prepared:
            # an input every rank holds whole, feeding an output that is
            # split over a mesh axis, gets a partial gradient on that axis
            grad_pl = tuple(
                Partial() if isinstance(p, Replicate)
                and any(isinstance(o[i], Shard) for o in out_pls) else p
                for i, p in enumerate(target))
            locals_.append(x.to_local(grad_placements=grad_pl))
            offsets.append(tuple(
                sl.start for sl in local_slices(self.mesh, _spec_of(axes),
                                                x.shape)))
        out = fn(*locals_, offsets=tuple(offsets), **kwargs)
        outs = [DTensor.from_local(o, self.mesh, pl, run_check=False)
                for o, pl in zip(out if several else (out,), out_pls)]
        return tuple(outs) if several else outs[0]


def local_slices(mesh, spec: Spec, shape: Sequence[int]) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` laid out by ``spec`` on
    ``mesh`` (a ``DeviceMesh``): one slice a dim, a dim over several axes
    split major to minor in the mesh's order."""
    order = list(mesh_shape(mesh))
    extent = mesh_shape(mesh)
    coord = mesh.get_coordinate()
    out = []
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        idx, n = 0, 1
        for a in axes:
            idx = idx * extent[a] + coord[order.index(a)]
            n *= extent[a]
        size = dim // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def _spec_of(axes: Tuple) -> Spec:
    parts = [None if not a else a[0] if len(a) == 1 else a for a in axes]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def make_act_resolver(mesh, rules: ShardingRules) -> ActResolver:
    """Resolver for distributed/api.activation_sharding."""
    return ActResolver(mesh, rules)


def batch_shardings(mesh, rules: ShardingRules, batch_abstract):
    """Input batches: leading dim is batch, everything else replicated.

    Exception: very long sequence dims (> 65536) are sequence-sharded (SP)
    when the batch dim cannot be (global_batch == 1 long-context cells).
    """
    def one(ab):
        shape = tuple(ab.shape)
        if not shape:
            return Layout(mesh, ())
        logical: list = [None] * len(shape)
        logical[0] = "batch"
        if shape[0] == 1 and len(shape) > 1 and shape[1] > 65536:
            logical[1] = "seq"
        return Layout(mesh, spec_for(mesh, rules, logical, shape))

    return _tree_map(one, batch_abstract)


def cache_shardings(mesh, rules: ShardingRules, cache_abstract,
                    global_batch: int, max_seq: int):
    """KV/SSM caches: shard the batch dim over data, the head-ish dim over
    model, and — when batch is unshardable (long-context, batch 1) — the
    sequence dim over data (SP).

    Dims are identified by SIZE (cache trees are heterogeneous across
    families): the first dim equal to ``global_batch`` is batch; the first
    later non-seq dim divisible by the model-axis extent is the TP dim.
    """
    model_extent = _axis_size(mesh, rules.get("heads"))

    def one(ab):
        shape = tuple(ab.shape)
        if len(shape) == 0:
            return Layout(mesh, ())
        logical: list = [None] * len(shape)
        b_dim = None
        for i, d in enumerate(shape):
            if i >= 1 and d == global_batch:
                b_dim = i
                break
        if b_dim is not None:
            logical[b_dim] = "batch"
            for i in range(b_dim + 1, len(shape)):
                if shape[i] == max_seq:
                    if global_batch == 1 and max_seq > 65536:
                        logical[i] = "seq"
                    continue
                if model_extent > 1 and shape[i] % model_extent == 0:
                    logical[i] = "kv"
                    break
        return Layout(mesh, spec_for(mesh, rules, logical, shape))

    return _tree_map(one, cache_abstract)
