"""``TuningJob`` / ``JobResult`` — the unit of fleet work.

A job is one (problem × input bucket × hardware) autotuning task: a tuning
space, the portable workload model for that input, the hardware target, and
a trial budget.  The fleet schedules many of them over one worker pool and
records each through its own ``EvalAccount`` (completion-ordered trace), so
per-job convergence stays comparable to single-job tuning while the pool's
wall-clock amortizes across the whole fleet.

A job is either PRICED or MEASURED.  A priced job (``device=None``) prices
each test through the analytic cost model on its ``hardware``, as the JAX
package's fleet does.  A measured job names a ``device``: each test
launches the registry kernel there and times it (``DeviceKernelEvaluator``),
on the spec detected for that card.  A job that names a card whose spec is
not its ``hardware`` is refused when it is built; a measured test is never
priced in its place.

``job_from_problem`` is the generic entry: any ``TuningProblem`` becomes a
fleet job, with the problem's ``kind`` namespacing its store artifacts and
its ``make_evaluator`` (when non-None) plugging in as the measurement
closure.  ``job_from_registry`` is the kernel-specific shim — jobs built
from the kernel registry also carry their ``(kernel, input_key)``
provenance, which is what subprocess worker backends ship across the
process boundary instead of the (unpicklable) workload closure.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core import hwspec
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.tuning_space import Config, TuningSpace


@dataclasses.dataclass
class TuningJob:
    """One (problem × input bucket × hardware) autotuning task."""

    name: str
    space: TuningSpace
    workload_fn: Callable[[Config], Dict[str, float]]
    hardware: Union[str, HardwareSpec]
    bucket: str = "default"          # input-shape bucket / input tag
    budget: int = 25                 # empirical-test budget
    seed: int = 0
    searcher: Optional[str] = None   # None = auto: warm_start on a stored
    #                                  artifact hit, else ``cold_searcher``
    cold_searcher: str = "random"
    kernel: Optional[str] = None     # registry provenance (subprocess pools)
    input_key: Optional[str] = None
    # override measurement: (index, profile) -> (runtime, counters, cost).
    # Default None = price workload_fn through the cost model on `hardware`
    # with the replay cost structure.  A measured job's is the card's
    # evaluator (``measure_fn``); thread pools time fn() wall-clock.
    eval_fn: Optional[Callable] = None
    # problem-kind namespace for the job's store artifacts.  None infers
    # the kind from the space name (``legacy_kind``).
    kind: Optional[str] = None
    # where each test runs: None prices it on the cost model; "cuda:N"
    # (or "cpu", the plain versions, for tests) measures it there
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kind is None:
            from repro_torch.tuning.store import legacy_kind
            self.kind = legacy_kind(self.space.name)

    def hw_spec(self) -> HardwareSpec:
        if isinstance(self.hardware, HardwareSpec):
            return self.hardware
        return hwspec.get(self.hardware)

    @property
    def hardware_key(self) -> str:
        """Normalized store key for this job's hardware target."""
        return hwspec.hardware_key(self.hardware)

    @property
    def measured(self) -> bool:
        return self.device is not None


def device_spec(device: str,
                hardware: Union[str, HardwareSpec, None],
                card: Optional[HardwareSpec] = None) -> HardwareSpec:
    """The spec a measured job runs on: the one detected for a CUDA card
    (or ``card``, its spec as the caller already knows it, so that nothing
    here touches CUDA), which must be ``hardware``'s when that is given; on
    the CPU (the plain versions, for tests) there is no card to detect, so
    ``hardware`` is required and taken as it is."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        if hardware is None:
            raise ValueError("a job measured on the CPU needs hardware=: "
                             "there is no card to detect a spec from")
        return (hardware if isinstance(hardware, HardwareSpec)
                else hwspec.get(hardware))
    if dev.type != "cuda":
        raise ValueError(f"a job measures on a CUDA card or the CPU, not "
                         f"{device!r}")
    detected = card if card is not None else hwspec.detect(
        dev.index if dev.index is not None else 0)
    if hardware is not None and \
            hwspec.hardware_key(hardware) != hwspec.hardware_key(detected):
        raise ValueError(
            f"{device} is a {detected.name} card, not "
            f"{hwspec.hardware_key(hardware)!r}: a measured job tunes the "
            "hardware it runs on")
    return detected


def measure_fn(kernel: str, input_key: str, hw: HardwareSpec,
               device: str) -> Callable:
    """``(index, profile) -> (runtime, counters, cost)`` measuring registry
    kernel ``kernel`` at input ``input_key`` on ``device``: a
    ``DeviceKernelEvaluator`` built at the first test (so building a job
    allocates nothing on the card) and reused for the rest."""
    holder: List = []
    lock = threading.Lock()

    def fn(index: int, profile: bool) -> Tuple:
        with lock:
            if not holder:
                from repro_torch.core.evaluate import DeviceKernelEvaluator
                from repro_torch.kernels.registry import BENCHMARKS

                bm = BENCHMARKS[kernel]
                holder.append(DeviceKernelEvaluator(
                    bm.space(), bm, bm.inputs[input_key], hw=hw,
                    device=device))
        return holder[0]._evaluate(int(index), bool(profile))

    return fn


def job_from_problem(problem, hardware: Union[str, HardwareSpec, None],
                     budget: int = 25, seed: int = 0,
                     searcher: Optional[str] = None,
                     cold_searcher: str = "random",
                     name: Optional[str] = None,
                     device: Optional[str] = None,
                     card: Optional[HardwareSpec] = None) -> TuningJob:
    """Build a fleet job from any ``TuningProblem``.

    Priced (``device=None``): the problem's ``make_evaluator(hw)`` — when
    it returns a closure — becomes the job's measurement substrate;
    ``None`` keeps the fleet's cost-model replay path, which keeps
    kernel-adapter jobs bit-identical to the JAX fleet's traces.
    Measured: a kernel problem's tests run on ``device`` (``measure_fn``),
    on the spec detected there (``hardware=None`` takes it), or on
    ``card`` when the caller knows that card's spec (``device_spec``).
    """
    if device is not None:
        if problem.kernel is None:
            raise ValueError(f"{problem!r} names no registry kernel: only "
                             "kernel problems are measured on a device")
        from repro_torch.kernels.registry import BENCHMARKS

        BENCHMARKS[problem.kernel].check_input(
            BENCHMARKS[problem.kernel].inputs[problem.input_key])
        hardware = device_spec(device, hardware, card)
    if hardware is None:
        raise ValueError("a priced job needs hardware=")
    hw_key = hwspec.hardware_key(hardware)
    job = TuningJob(
        name=name if name is not None
        else f"{problem.kind}:{problem.name}@{hw_key}",
        space=problem.space(),
        workload_fn=problem.workload_fn(),
        hardware=hardware,
        bucket=problem.bucket,
        budget=budget,
        seed=seed,
        searcher=searcher,
        cold_searcher=cold_searcher,
        kernel=problem.kernel,
        input_key=problem.input_key,
        kind=problem.kind,
        device=device,
    )
    if device is not None:
        job.eval_fn = measure_fn(problem.kernel, problem.input_key,
                                 job.hw_spec(), device)
    else:
        job.eval_fn = problem.make_evaluator(job.hw_spec())
    return job


def job_from_registry(kernel: str, input_key: str,
                      hardware: Union[str, HardwareSpec, None],
                      budget: int = 25, seed: int = 0,
                      searcher: Optional[str] = None,
                      cold_searcher: str = "random",
                      device: Optional[str] = None,
                      card: Optional[HardwareSpec] = None) -> TuningJob:
    """Kernel-registry shim: ``job_from_problem`` over a
    ``KernelProblem``, keeping the ``kernel/input@hw`` job name."""
    from repro_torch.tuning.problem import KernelProblem

    job = job_from_problem(
        KernelProblem(kernel, input_key), hardware, budget=budget, seed=seed,
        searcher=searcher, cold_searcher=cold_searcher, device=device,
        card=card)
    job.name = f"{kernel}/{input_key}@{job.hardware_key}"
    return job


@dataclasses.dataclass
class JobResult:
    """Outcome of one fleet job, read off its completion-ordered account.

    ``best_index`` is ``None`` only in the degenerate fault case where
    every empirical test of the job failed (its ``known_bad`` then lists
    the crashed configs and ``best_runtime`` is ``inf``) — the fleet still
    completes and reports it instead of dying.  Known-bad configs appear
    in the trace/history as ``inf``-runtime rows, so ``trials`` counts
    every *resolved* test, successful or not; ``failures`` counts failed
    attempts (including retried ones) and ``abandoned_s`` the
    worker-seconds those burned — already included in ``busy``.
    """

    job: str
    bucket: str
    hardware: str
    searcher: str
    warm_started: bool
    best_index: Optional[int]
    best_config: Config
    best_runtime: float
    trials: int                  # empirical tests resolved (incl. known-bad)
    elapsed: float               # job's completion frontier on the pool clock
    busy: float                  # worker-seconds spent on this job
    trace: List[Tuple[int, float, float]]
    history: List[Tuple[int, float]]
    failures: int = 0            # failed attempts observed (pre-retry)
    abandoned_s: float = 0.0     # worker-seconds of discarded attempts
    known_bad: List[int] = dataclasses.field(default_factory=list)
    parked: bool = False         # scheduler parked it inside the well band
    cancelled: bool = False      # cancelled mid-run (drain path): partial
    #                              results, nothing published
    # cross-space transfer provenance: set only when the warm start came
    # from the store's compatible-space tier (all four exact-space tiers
    # missed) — the source artifact's store key and the structural
    # similarity that justified using it
    transfer_from: Optional[str] = None
    transfer_similarity: Optional[float] = None
    # the store key of the exact-space artifact a warm start walked (None:
    # cold, or transferred — see ``transfer_from``)
    warm_from: Optional[str] = None

    def trials_to_threshold(self, threshold: float) -> Optional[int]:
        """Completed trials until runtime <= threshold (None: never)."""
        for steps, _, rt in self.trace:
            if rt <= threshold:
                return steps
        return None
