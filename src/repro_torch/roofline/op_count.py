"""Per-rank op counts of one step — the dry run's "performance counters".

The JAX package's counterpart is ``repro/roofline/hlo_parse.py``: it
walks the compiled HLO of a step lowered for 256 or 512 chips and adds up
one device's flops, bytes, transcendentals and collective bytes.  Here the
step runs eagerly on fake tensors (``torch._subclasses.FakeTensorMode``:
shapes and dtypes, no storage) on a fake process group, and ``OpCounter``,
a ``TorchDispatchMode``, counts rank 0's local ops as they are dispatched:

* **flops** by the unit that prices them: ``bf16`` for products of bf16 or
  fp16 operands (the tensor cores), ``fp32`` for fp32 products and every
  elementwise op and reduction (the fp32 lanes), ``tf32x3`` for the
  attention kernel's products (three TF32 products each on the card).
  Products use PyTorch's own formulas (``torch.utils.flop_counter``); an
  elementwise op counts one flop an output element, a reduction one an
  input element, as the HLO parser counts its elementwise kinds;
* **transcendentals**: one an output element of exp, log, tanh, the
  sigmoid family, rsqrt, sqrt, sin, cos, pow, erf and softmax;
* **bytes**: every op that is not a view reads its operands and writes its
  results (eager PyTorch runs op by op, so there are no fusions for the
  count to see through); a view moves nothing;
* **collectives**: the ``c10d_functional`` ops that ``DTensor`` issues
  (``CommDebugMode`` names them), each counted at its output's bytes, the
  per-participant bytes the HLO parser reads off a collective's shape, by
  kind under the JAX names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``) and by link: ``nvlink`` where the
  group's ranks lie within one node of ``NODE_CARDS`` cards, ``net`` where
  they cross nodes;
* **launches** of the hand-written kernels: the attention kernel is the
  operator ``repro_torch::flash_attention`` (its wrapper calls it on fake
  tensors as on the card), one launch a call with the kernel's own work:
  ``attention_flops`` under ``tf32x3``, q, k, v read and o written;
* **peak live bytes**: every storage from its allocation until it is freed
  (weak references to the fake storages), parameters, moments, the batch,
  activations and gradients alike: the counterpart of the compiled
  program's argument + temp sizes (``memory_analysis()``);
* **by call site**, with ``OpCounter(sites=True)``: the collective bytes
  (by link and kind) and the bytes live at the peak, each under the
  innermost frame of the port's model, train, optimizer or data code that
  issued it (``models/common.py:embed_lookup``).  An op of the backward
  is put under the site of the forward op whose gradient it computes,
  marked ``(backward)``: autograd's anomaly mode keeps each node's
  forward stack (``check_nan=False``: fake tensors hold no values), read
  through ``torch._C._current_autograd_node()``.  A remat recompute runs
  the forward's own frames and counts under them.  The storages live when
  the count began stand under ``arguments``.

There is no trip-count pass: the HLO parser needs one because XLA counts a
``while`` body (the scan over layers) once, but eager PyTorch runs every
layer, every microbatch and every remat recompute, and each op is counted
as it runs.

``DTensor`` shows the counter its own ops first: the counter declines them
(``NotImplemented``), and ``DTensor`` dispatches each rank's local op,
which the counter counts.  Sharding propagation also runs ops of its own
on fake tensors: each op once at the global shape, to learn the output's
shape, and, the first time an op without a rule of its own is seen in a
process, its decomposition, to learn its strategy.  The counter skips
everything inside ``ShardingPropagator``'s uncached passes
(``_SHAPE_PASSES``), so that each local op is counted once (a test holds a
sharded product to its hand count) and a count does not depend on what
the process counted before (a test counts one cell twice).
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import threading
import warnings
import weakref
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

NODE_CARDS = 8            # cards a node, joined by NVLink

_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "pow", "erf", "silu", "gelu",
    "softplus", "log_sigmoid_forward", "_softmax", "_log_softmax",
    "tanh_backward", "sigmoid_backward"))
_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "norm", "linalg_vector_norm", "var_mean",
    "var", "std", "prod", "cumsum", "logsumexp", "any", "all"))
# ops that allocate without writing, or touch only metadata
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "detach", "lift_fresh",
    "_local_scalar_dense", "wait_tensor", "set_", "resize_", "device",
    "layout", "dim", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size"))
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_KERNELS = {"flash_attention": "attention"}
# the parts of the port whose frames name a call site (by path)
_SITE_DIRS = ("/repro_torch/models/", "/repro_torch/train/",
              "/repro_torch/optim/", "/repro_torch/data/")

_shape_pass = threading.local()
# ShardingPropagator's passes whose ops are DTensor's planning, not the
# rank's (the ones a torch version has are patched)
_SHAPE_PASSES = ("_propagate_tensor_meta_non_cached",
                 "propagate_op_sharding_non_cached")


@dataclasses.dataclass
class OpCount:
    """One rank's totals of one step."""

    flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"bf16": 0.0, "fp32": 0.0, "tf32x3": 0.0})
    # the products alone (PyTorch's ``FlopCounterMode`` would count these),
    # in all and by op (``mm``, ``bmm``, ``flash_attention``, ...)
    product_flops: float = 0.0
    product_flops_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # link ("nvlink" | "net") -> kind -> bytes
    collective_links: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0
    argument_bytes: float = 0.0    # live when the count began
    peak_bytes: float = 0.0        # most live at once
    final_bytes: float = 0.0       # live when the count ended
    # with sites: site -> link -> kind -> bytes; site -> bytes at the peak
    collective_sites: Dict[str, Dict[str, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)
    peak_sites: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())


@functools.lru_cache(maxsize=None)
def _kind(func):
    """(name, kind, product formula, pointwise, transcendental) of an op,
    worked out once: kind is "free" (a view, metadata, an allocation that
    writes nothing), "collective", "kernel", "reduction" or "op"."""
    from torch.utils.flop_counter import flop_registry

    name = func._schema.name.split("::")[-1]
    ns = func.namespace
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    if name in _FREE or ns == "prim" or view:
        kind = "free"
    elif ns == "_c10d_functional":
        kind = "collective"
    elif ns == "repro_torch" and name in _KERNELS:
        kind = "kernel"
    elif name in _REDUCTIONS:
        kind = "reduction"
    else:
        kind = "op"
    return (name, kind, flop_registry.get(func._overloadpacket),
            torch.Tag.pointwise in func.tags,
            name.rstrip("_") in _TRANSCENDENTAL)


def _tensors(tree):
    """The tensors of an op's arguments or results (lists, tuples, dicts
    of them)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _group_ranks(group_name: str):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def _real_index_math():
    """``DTensor`` computes a strided shard's local rows with a small index
    tensor (``torch.arange``) and reads it back (``tolist``); under a
    ``FakeTensorMode`` that tensor is fake and cannot be read.  While the
    counter is entered, that computation runs with the fake mode set
    aside, on a real index tensor of a few elements.  Returns the
    (class, name, original) it replaced."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    if cls is None or name not in cls.__dict__:
        return []
    orig = cls.__dict__[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)

    setattr(cls, name, staticmethod(real) if isinstance(orig, staticmethod)
            else real)
    return [(cls, name, orig)]


def _site_name(path: str, func: str) -> Optional[str]:
    for d in _SITE_DIRS:
        i = path.rfind(d)
        if i >= 0:
            return f"{path[i + len('/repro_torch/'):]}:{func}"
    return None


def _live_site() -> Optional[str]:
    """The innermost frame of the stack in a site directory."""
    f = sys._getframe(2)
    while f is not None:
        site = _site_name(f.f_code.co_filename, f.f_code.co_name)
        if site is not None:
            return site
        f = f.f_back
    return None


def _node_site(node) -> Optional[str]:
    """The innermost site of an autograd node's forward stack (anomaly
    mode's ``traceback_``: formatted frames, outermost first)."""
    for frame in reversed(node.metadata.get("traceback_", ())):
        head = frame.lstrip().split("\n", 1)[0]     # File "p", line n, in f
        if head.startswith('File "') and ", in " in head:
            path = head[len('File "'):head.index('"', len('File "'))]
            site = _site_name(path, head.rsplit(", in ", 1)[1])
            if site is not None:
                return site
    return None


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (inside a
    ``FakeTensorMode``, or on real tensors): ``count`` holds the totals.
    ``track`` registers tensors that exist already (the state, the batch)
    as live memory.  ``sites`` adds the collective bytes and the peak's
    bytes by call site (``OpCount.collective_sites``, ``peak_sites``)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.count = OpCount()
        self.sites = sites
        self._live: Dict[int, tuple] = {}
        self._now = 0.0
        self._by_site: Dict[str, float] = {}
        self._site: Optional[str] = None    # the op being accounted's
        self._links: Dict[str, str] = {}
        self._patched = None
        self._anomaly = None

    # -- call sites ----------------------------------------------------------
    def _call_site(self) -> str:
        """The op's site: the live stack's, or in the backward (no model
        frame live) the forward's that made the current node."""
        live = _live_site()
        node = torch._C._current_autograd_node()
        if node is not None and (live is None
                                 or not live.startswith("models/")):
            fwd = _node_site(node)
            if fwd is not None:
                return fwd + " (backward)"
        return live or "other"

    # -- memory -------------------------------------------------------------
    def _free(self, key: int) -> None:
        n, site = self._live.pop(key, (0.0, None))
        self._now -= n
        if site is not None:
            self._by_site[site] -= n

    def _hold(self, t: torch.Tensor, site: Optional[str] = None) -> None:
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = float(st.nbytes())
        if self.sites:
            site = site or self._site or self._call_site()
            self._by_site[site] = self._by_site.get(site, 0.0) + n
        else:
            site = None
        self._live[key] = (n, site)
        self._now += n
        weakref.finalize(st, self._free, key)
        if self._now > self.count.peak_bytes:
            self.count.peak_bytes = self._now
            if self.sites:
                self.count.peak_sites = {k: v for k, v in
                                         self._by_site.items() if v}

    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees`` (modules,
        dicts, tuples; a ``DTensor`` by its local tensor) as live."""
        from torch.distributed.tensor import DTensor

        for leaf in tree_flatten(trees)[0]:
            tensors = ([*leaf.parameters(), *leaf.buffers()]
                       if isinstance(leaf, torch.nn.Module) else [leaf])
            for t in tensors:
                if isinstance(t, DTensor):
                    t = t._local_tensor
                if isinstance(t, torch.Tensor):
                    self._hold(t, "arguments")
        self.count.argument_bytes = self._now

    # -- the mode --------------------------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        def shape_pass(orig):
            def run(*args, **kwargs):
                prev = getattr(_shape_pass, "on", False)
                _shape_pass.on = True
                try:
                    return orig(*args, **kwargs)
                finally:
                    _shape_pass.on = prev
            return run

        self._patched = []
        for name in _SHAPE_PASSES:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is not None:
                self._patched.append((ShardingPropagator, name, orig))
                setattr(ShardingPropagator, name, shape_pass(orig))
        self._patched += _real_index_math()
        if self.sites:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # "enabled for debugging"
                self._anomaly = torch.autograd.set_detect_anomaly(
                    True, check_nan=False)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for cls, name, orig in self._patched:
                setattr(cls, name, orig)
            if self._anomaly is not None:
                self._anomaly.__exit__(None, None, None)
                self._anomaly = None
            self.count.final_bytes = self._now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_shape_pass, "on", False):
            return out
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        c = self.count
        name, kind, formula, pointwise, trans = _kind(func)
        outs = list(_tensors(out))
        self._site = self._call_site() if self.sites and outs else None
        for t in outs:
            self._hold(t)
        if kind == "free":
            return
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        c.ops += 1
        if kind == "collective":
            op = _COLLECTIVES.get(name, name)
            b = sum(_nbytes(t) for t in outs)
            group = next(a for a in reversed(args) if isinstance(a, str))
            link = self._link(group)
            c.collective_bytes[op] = c.collective_bytes.get(op, 0.0) + b
            c.collective_counts[op] = c.collective_counts.get(op, 0) + 1
            per = c.collective_links.setdefault(link, {})
            per[op] = per.get(op, 0.0) + b
            if self.sites:
                at = c.collective_sites.setdefault(
                    self._site or self._call_site(), {}).setdefault(link, {})
                at[op] = at.get(op, 0.0) + b
            c.bytes += 2.0 * b
            return
        c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                      for t in outs)
        if kind == "kernel":
            from repro_torch.kernels.attention.kernel import attention_flops

            kernel = _KERNELS[name]
            c.launches[kernel] = c.launches.get(kernel, 0) + 1
            f = attention_flops(tuple(args[0].shape), bool(args[7]),
                                args[2].shape[-1])
            c.flops["tf32x3"] += f
            self._product(name, f)
            return
        if formula is not None:
            low = bool(ins) and ins[0].dtype in (torch.bfloat16,
                                                 torch.float16)
            f = float(formula(*args, **kwargs, out_val=out))
            c.flops["bf16" if low else "fp32"] += f
            self._product(name, f)
            return
        if kind == "reduction":
            c.flops["fp32"] += float(ins[0].numel()) if ins else 0.0
        elif pointwise:
            c.flops["fp32"] += float(sum(t.numel() for t in outs))
        if trans:
            c.transcendentals += float(sum(t.numel() for t in outs))

    def _product(self, name: str, flops: float) -> None:
        c = self.count
        c.product_flops += flops
        c.product_flops_by_op[name] = c.product_flops_by_op.get(name, 0.0) \
            + flops

    def _link(self, group_name: str) -> str:
        link = self._links.get(group_name)
        if link is None:
            nodes = {r // NODE_CARDS for r in _group_ranks(group_name)}
            link = "nvlink" if len(nodes) <= 1 else "net"
            self._links[group_name] = link
        return link


def count_ops(fn, *args, track: Iterable = (), sites: bool = False,
              **kwargs):
    """``fn(*args, **kwargs)`` under an ``OpCounter`` that holds the
    tensors of ``track`` live from the start; returns (its result, the
    ``OpCount``)."""
    counter = OpCounter(sites=sites)
    with counter:
        counter.track(*track)
        out = fn(*args, **kwargs)
    return out, counter.count

