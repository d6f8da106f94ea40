"""``TuningProblem`` — one tuner-facing interface from kernel tiles to
whole-system spaces.

The paper's method is problem-agnostic: a tuning space, a portable
workload model ``g : TP × I → PC_ops`` whose counters feed the TP→PC
model, and (optionally) a measurement substrate for the hardware of
interest.  This module lifts that contract out of the kernel registry so
the store and the searchers tune anything that speaks it.  It is the JAX
package's module carried over, with its three problem kinds:

* ``kernel`` — a thin adapter over ``kernels/registry.py``: one of the
  port's hand-written Hopper kernels on one named registry input;
* ``sharding`` — ``repro_torch.distributed.tuning.ShardingProblem``: the
  train-step layout (mesh × FSDP × SEQ × GA) of one model-zoo entry,
  priced on the cost model;
* ``serve`` — ``repro_torch.serve.autotune.ServeProblem``: the serving
  wave geometry (BATCH × MAX_SEQ) of one shape bucket, priced on the
  cost model.

``system_problems`` lists all three for one model-zoo entry, the fleet
CLI's ``--system`` mode.  The fleet (``repro_torch.fleet``) schedules
problems of every kind.

A problem also names its identity in the persistent ``ConfigStore``:
``kind`` is the key namespace (``kind|space|bucket|hardware``) and
``bucket`` the input-shape bucket, so artifacts from different problem
kinds never collide even when space names do.

The string registry (``register_problem_kind`` / ``make_problem`` /
``parse_problem``) resolves ``kind:name`` specs such as
``kernel:conv2d/4096``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.tuning_space import Config, TuningSpace


class TuningProblem:
    """The tuner-facing contract every problem kind implements.

    Subclasses set class attribute ``kind`` (the store-key namespace and
    registry string) and instance attributes ``name`` (unique within the
    kind, e.g. ``"matmul/2048"`` or ``"qwen2.5-3b/train_4k"``) and
    ``bucket`` (the input-shape bucket the paper's ``I``), then implement:

    * ``space()`` — the ``TuningSpace`` to search;
    * ``workload_fn()`` — the portable counter model ``g(TP) → PC_ops``
      (hardware-independent; trains the TP→PC model and prices
      warm-start rankings);
    * ``make_evaluator(hw)`` — an optional measurement closure
      ``(index, profile) -> (runtime, counters, cost)`` for the hardware
      of interest.  ``None`` (the default) means "price ``workload_fn``
      through the analytic cost model" — the fleet's replay path, which
      keeps the kernel adapter bit-identical to the legacy traces.

    ``kernel``/``input_key`` are registry provenance for subprocess
    worker pools (which ship names, not closures); non-kernel problems
    leave them ``None`` and therefore need in-process pools.
    """

    kind: str = "problem"
    name: str = ""
    bucket: str = "default"
    kernel: Optional[str] = None
    input_key: Optional[str] = None

    def space(self) -> TuningSpace:
        raise NotImplementedError

    def workload_fn(self) -> Callable[[Config], Dict[str, float]]:
        raise NotImplementedError

    def make_evaluator(self, hw: HardwareSpec) -> Optional[Callable]:
        return None

    @property
    def spec(self) -> str:
        """The registry string that reconstructs this problem."""
        return f"{self.kind}:{self.name}"

    def describe(self) -> Dict[str, Any]:
        """Problem card for enumeration tools (``gen_experiments``)."""
        sp = self.space()
        return {
            "kind": self.kind,
            "name": self.name,
            "bucket": self.bucket,
            "space": sp.name,
            "n_configs": len(sp),
            "parameters": {p.name: list(p.values) for p in sp.parameters},
        }

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


# =============================================================================
# The string-keyed registry
# =============================================================================
_FACTORIES: Dict[str, Callable[..., TuningProblem]] = {}
_LISTERS: Dict[str, Callable[[], List[str]]] = {}


def register_problem_kind(kind: str,
                          lister: Optional[Callable[[], List[str]]] = None):
    """Register a factory ``f(name, **params) -> TuningProblem`` for
    ``kind`` (decorator).  ``lister`` optionally enumerates example
    problem names of the kind for discovery tools."""
    def deco(factory):
        _FACTORIES[kind] = factory
        if lister is not None:
            _LISTERS[kind] = lister
        return factory
    return deco


def problem_kinds() -> List[str]:
    """All registered problem kinds, sorted."""
    return sorted(_FACTORIES)


def make_problem(kind: str, name: str, **params: Any) -> TuningProblem:
    """Instantiate a registered problem kind by name."""
    if kind not in _FACTORIES:
        raise KeyError(
            f"unknown problem kind {kind!r}; valid kinds: "
            f"{', '.join(problem_kinds())}")
    return _FACTORIES[kind](name, **params)


def parse_problem(spec: str, **params: Any) -> TuningProblem:
    """Resolve a ``kind:name`` spec (the CLI/service form) to a problem."""
    kind, sep, name = spec.partition(":")
    if not sep or not kind or not name:
        raise ValueError(
            f"problem spec must be 'kind:name', got {spec!r}; valid "
            f"kinds: {', '.join(problem_kinds())}")
    return make_problem(kind, name, **params)


def list_problems(kind: Optional[str] = None) -> List[str]:
    """Example ``kind:name`` specs across registered kinds (or one kind)."""
    kinds = [kind] if kind is not None else problem_kinds()
    out: List[str] = []
    for k in kinds:
        lister = _LISTERS.get(k)
        if lister is not None:
            out.extend(f"{k}:{n}" for n in lister())
    return out


# =============================================================================
# kind = "kernel" — the registry adapter (bit-identical to the legacy path)
# =============================================================================
class KernelProblem(TuningProblem):
    """A registered Hopper kernel benchmark on one named input.

    ``make_evaluator`` returns ``None``, as in the JAX package: a fleet
    job built from the problem with no device prices the workload through
    the analytic cost model.  A fleet job with a device
    (``job_from_problem(problem, hw, device="cuda:0")``) measures on it:
    each test launches ``BENCHMARKS[problem.kernel]`` at input
    ``problem.input_key`` there and times it (``DeviceKernelEvaluator``).
    """

    kind = "kernel"

    def __init__(self, kernel: str, input_key: Optional[str] = None):
        from repro_torch.kernels.registry import BENCHMARKS
        if kernel not in BENCHMARKS:
            raise KeyError(f"unknown kernel {kernel!r}; available: "
                           f"{sorted(BENCHMARKS)}")
        bm = BENCHMARKS[kernel]
        if input_key is None:
            input_key = sorted(bm.inputs)[0]
        if input_key not in bm.inputs:
            raise KeyError(f"kernel {kernel!r} has no input {input_key!r}; "
                           f"available: {sorted(bm.inputs)}")
        self._bm = bm
        self.kernel = kernel
        self.input_key = input_key
        self.name = f"{kernel}/{input_key}"
        self.bucket = input_key

    def space(self) -> TuningSpace:
        return self._bm.space()

    def workload_fn(self) -> Callable[[Config], Dict[str, float]]:
        bm, inp = self._bm, self._bm.inputs[self.input_key]
        return lambda cfg: bm.workload_fn(cfg, inp)


def _kernel_names() -> List[str]:
    from repro_torch.kernels.registry import BENCHMARKS
    return [f"{k}/{i}" for k in sorted(BENCHMARKS)
            for i in sorted(BENCHMARKS[k].inputs)]


@register_problem_kind("kernel", lister=_kernel_names)
def _make_kernel(name: str, **params: Any) -> KernelProblem:
    kernel, _, input_key = name.partition("/")
    return KernelProblem(kernel, input_key or None, **params)


# =============================================================================
# kind = "sharding" / "serve" — lazy factories (heavy imports on demand)
# =============================================================================
def _sharding_names() -> List[str]:
    from repro_torch.configs import ARCHS
    return [f"{a}/train_4k" for a in sorted(ARCHS)]


@register_problem_kind("sharding", lister=_sharding_names)
def _make_sharding(name: str, **params: Any) -> TuningProblem:
    from repro_torch.distributed.tuning import ShardingProblem
    return ShardingProblem.from_name(name, **params)


def _serve_names() -> List[str]:
    return ["p9n9", "p4n4", "p9n0"]


@register_problem_kind("serve", lister=_serve_names)
def _make_serve(name: str, **params: Any) -> TuningProblem:
    from repro_torch.serve.autotune import ServeProblem
    return ServeProblem.from_name(name, **params)


# =============================================================================
# Whole-system convenience: every problem kind for one model-zoo entry
# =============================================================================
def system_problems(arch: str, shape: str = "train_4k",
                    n_devices: int = 64,
                    kernels: Optional[List[str]] = None
                    ) -> List[TuningProblem]:
    """Kernel tiles + train-step sharding + serve geometry for one
    model-zoo entry — the one-invocation ``launch/fleet.py --system``
    mode tunes exactly this list through one fleet and one store."""
    from repro_torch.distributed.tuning import ShardingProblem
    from repro_torch.kernels.registry import BENCHMARKS
    from repro_torch.serve.autotune import ServeProblem

    problems: List[TuningProblem] = []
    for k in (kernels if kernels is not None else sorted(BENCHMARKS)):
        problems.append(KernelProblem(k))
    problems.append(ShardingProblem.from_name(f"{arch}/{shape}",
                                              n_devices=n_devices))
    problems.append(ServeProblem.from_name("p9n9", arch=arch))
    return problems
