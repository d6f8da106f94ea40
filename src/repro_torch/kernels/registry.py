"""Kernel benchmark registry: uniform access to the port's kernels for
tests, checks and the tuning session.

Each entry binds: tuning space, config→kernel dispatch, the oracle, the
portable workload model g(TP, I), and a catalog of inputs (the paper's
input-portability experiments need several per benchmark).  The contract is
the JAX package's, with torch tensors: ``make_args(inp, rng, device)`` draws
the JAX package's arrays from the numpy ``rng`` and moves them to
``device``, and ``run(cfg, *args)`` launches the kernel.

A kernel package registers itself in its ``__init__``::

    @register_benchmark("matmul")
    def _benchmark() -> KernelBenchmark: ...

and ``BENCHMARKS`` imports the packages lazily on first access.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Tuple)

from repro_torch.core.tuning_space import Config, TuningSpace


@dataclasses.dataclass
class KernelBenchmark:
    name: str
    make_space: Callable[[], TuningSpace]
    workload_fn: Callable[[Config, Any], Dict[str, float]]
    default_input: Any
    inputs: Dict[str, Any]
    make_args: Callable[[Any, Any, Any], Tuple]   # make_args(inp, rng, device)
    run: Callable[..., Any]       # run(cfg, *args)
    ref: Callable[..., Any]       # ref(*args)
    # inp -> None, raising for an input no configuration of the space can
    # run; called before a tune's first test (``check_input``)
    validate_input: Optional[Callable[[Any], None]] = None
    _space: TuningSpace = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def check_input(self, inp: Any) -> None:
        """Raise (``ValueError``) for an input the kernel refuses at every
        configuration, so that a tune fails before its first test and not
        partway through a sweep."""
        if self.validate_input is not None:
            self.validate_input(inp)

    def space(self) -> TuningSpace:
        """Memoized ``make_space()`` (read-only; call ``make_space()`` for a
        private copy)."""
        if self._space is None:
            self._space = self.make_space()
        return self._space


_FACTORIES: Dict[str, Callable[[], KernelBenchmark]] = {}


def register_benchmark(name: str):
    """Decorator for a zero-arg factory returning a ``KernelBenchmark``."""

    def deco(factory: Callable[[], KernelBenchmark]):
        if name in _FACTORIES:
            raise ValueError(f"benchmark {name!r} registered twice")
        _FACTORIES[name] = factory
        return factory

    return deco


class _BenchmarkRegistry(Mapping):
    """Lazy name → KernelBenchmark mapping over the registered factories."""

    def __init__(self) -> None:
        self._built: Dict[str, KernelBenchmark] = {}
        self._discovered = False

    def _discover(self) -> None:
        """Import every repro_torch.kernels subpackage so decorators run."""
        if self._discovered:
            return
        import repro_torch.kernels as pkg

        for mod in pkgutil.iter_modules(pkg.__path__):
            if mod.ispkg:
                importlib.import_module(f"repro_torch.kernels.{mod.name}")
        self._discovered = True

    def __getitem__(self, name: str) -> KernelBenchmark:
        self._discover()
        if name not in self._built:
            if name not in _FACTORIES:
                raise KeyError(
                    f"unknown benchmark {name!r}; "
                    f"registered: {sorted(_FACTORIES)}")
            bench = _FACTORIES[name]()
            if bench.name != name:
                raise ValueError(
                    f"benchmark factory for {name!r} returned name "
                    f"{bench.name!r}")
            self._built[name] = bench
        return self._built[name]

    def __iter__(self) -> Iterator[str]:
        self._discover()
        return iter(sorted(_FACTORIES))

    def __len__(self) -> int:
        self._discover()
        return len(_FACTORIES)


BENCHMARKS: Mapping[str, KernelBenchmark] = _BenchmarkRegistry()
