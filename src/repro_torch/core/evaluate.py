"""Evaluators: configuration → (runtime, performance counters).

The paper's evaluation replays exhaustively recorded tuning spaces 1000x
instead of re-running kernels (§4.1).  ``RecordedSpace`` holds such a record;
``ReplayEvaluator`` serves it to searchers while accounting empirical-test
steps and simulated wall-clock (profiled runs are slower — §4.6).

``CostModelEvaluator`` produces records from a kernel workload model
(g: TP × I → PC_ops) executed on the analytic machine (f: ... × GPU →
runtime).  ``DeviceKernelEvaluator`` launches the kernel on the card and
times it.  ``FunctionEvaluator`` adapts any ``cfg -> seconds`` callable
(runtime-only — no counters, so only counter-free searchers can drive it).

All evaluators implement the shared ``repro_torch.core.account.Evaluator``
protocol: ``measure`` / ``profile`` / ``measure_many`` / ``submit`` /
``collect`` plus the uniform ``EvalAccount`` bookkeeping (steps, elapsed,
busy, trace, history, best).  ``VirtualAsyncEvaluator`` wraps any of them
in a simulated ``workers``-lane concurrent backend (deterministic virtual
clock) — the reference implementation of the async half of the protocol.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import costmodel, hwspec
from repro_torch.core.account import (Candidate, Evaluator, Observation,
                                      ProfilingUnsupported, Ticket)
from repro_torch.core.counters import CounterSet
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.tuning_space import Config, TuningSpace
from repro_torch.device import resolve_device

# Empirical-test cost structure (seconds), mirroring §4.6 observations:
# every test pays compile+launch+data overhead; profiled tests additionally
# re-run the kernel per counter group (CUPTI-style multi-pass ≈ 4x slowdown).
TEST_OVERHEAD = 0.02
PROFILE_SLOWDOWN = 4.0
PROFILE_FIXED = 0.08


@dataclasses.dataclass
class RecordedSpace:
    """Exhaustive (runtime, counters) record of one space on one hardware."""

    space: TuningSpace
    runtimes: np.ndarray
    counters: List[CounterSet]
    hw: HardwareSpec
    input_tag: str = ""

    @property
    def best_runtime(self) -> float:
        return float(self.runtimes.min())

    def well_performing_mask(self, factor: float = 1.1) -> np.ndarray:
        """Configs within ``factor`` of the best runtime (paper §4.1)."""
        return self.runtimes <= factor * self.best_runtime

    def ops_list(self) -> List[Dict[str, float]]:
        return [cs.ops for cs in self.counters]


def record_space(
    space: TuningSpace,
    workload_fn: Callable[[Config], Dict[str, float]],
    hw: HardwareSpec,
    input_tag: str = "",
) -> RecordedSpace:
    """Exhaustively evaluate a space on the analytic machine."""
    counters: List[CounterSet] = []
    runtimes = np.empty(len(space), dtype=np.float64)
    for i, cfg in enumerate(space):
        cs = costmodel.execute(workload_fn(cfg), hw)
        counters.append(cs)
        runtimes[i] = cs.runtime
    return RecordedSpace(space=space, runtimes=runtimes, counters=counters,
                         hw=hw, input_tag=input_tag)


class ReplayEvaluator(Evaluator):
    """Serves a RecordedSpace to a searcher; accounts steps and time.

    ``steps``  — number of empirical tests (paper's primary metric)
    ``elapsed`` — simulated tuning wall-clock (runtime + overheads)
    ``trace``  — (steps, elapsed, runtime) per test, for convergence curves
    """

    def __init__(self, recorded: RecordedSpace):
        super().__init__(recorded.space)
        self.recorded = recorded

    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, Optional[CounterSet], float]:
        rt = float(self.recorded.runtimes[idx])
        if profiled:
            cost = rt * PROFILE_SLOWDOWN + TEST_OVERHEAD + PROFILE_FIXED
            return rt, self.recorded.counters[idx], cost
        return rt, None, rt + TEST_OVERHEAD


class CostModelEvaluator(Evaluator):
    """Live evaluator: workload model + analytic hardware (no record needed)."""

    def __init__(
        self,
        space: TuningSpace,
        workload_fn: Callable[[Config], Dict[str, float]],
        hw: HardwareSpec,
    ):
        super().__init__(space)
        self.workload_fn = workload_fn
        self.hw = hw
        self._cache: Dict[int, CounterSet] = {}

    def _counters_for(self, idx: int) -> CounterSet:
        if idx not in self._cache:
            self._cache[idx] = costmodel.execute(
                self.workload_fn(self.space[idx]), self.hw
            )
        return self._cache[idx]

    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, Optional[CounterSet], float]:
        cs = self._counters_for(idx)
        rt = float(cs.runtime)
        if profiled:
            cost = rt * PROFILE_SLOWDOWN + TEST_OVERHEAD + PROFILE_FIXED
            return rt, cs, cost
        return rt, None, rt + TEST_OVERHEAD


class FunctionEvaluator(Evaluator):
    """Adapts a plain ``cfg -> runtime_seconds`` callable to the protocol.

    Used to tune things with no counter story (e.g. serving batch sizes):
    ``profile`` raises ``ProfilingUnsupported``, so drive it with
    counter-free searchers (random, basin hopping, starchart, warm_start).

    Cost model: ``elapsed`` accounts seconds actually spent in ``fn``.  With
    ``cache=True`` (default) the first measurement of a config runs ``fn``
    and charges its runtime; re-measurements of the same config are served
    from the memo and charge **zero** additional elapsed — ``fn`` never
    re-ran, so billing it again would overstate tuning cost.  This differs
    from ``ReplayEvaluator`` deliberately: replay's clock is *simulated* and
    charges every empirical test because each one stands in for a real
    kernel launch.  Pass ``cache=False`` to genuinely re-run ``fn`` per
    measurement (e.g. noisy live timings that should be re-sampled); each
    test then pays its own cost, matching replay's re-measure semantics.
    Steps/trace/history count every measurement in both modes.
    """

    def __init__(self, space: TuningSpace,
                 fn: Callable[[Config], float],
                 cache: bool = True):
        super().__init__(space)
        self.fn = fn
        self.cache = cache
        self._cache: Dict[int, float] = {}

    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, Optional[CounterSet], float]:
        if not self.cache:
            rt = float(self.fn(self.space[idx]))
            return rt, None, rt
        if idx in self._cache:
            return self._cache[idx], None, 0.0  # memo hit: fn did not re-run
        rt = float(self.fn(self.space[idx]))
        self._cache[idx] = rt
        return rt, None, rt


# Bytes written before each timed launch, so that the launch finds the L2
# cache (50 MB on the H100) holding none of its operands.
L2_FLUSH_BYTES = 128 * 2**20

# One timed window a card at a time: the CUDA events of a test bracket
# everything queued on the card between them, so two threads timing on one
# card would each count the other's flushes and launches.
_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device: torch.device) -> threading.Lock:
    """The lock that serializes timed measurements on ``device``."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(device), threading.Lock())


class _Gate:
    """``csrc/gate.cu``: a gate that holds the card before a timed launch
    until the host has queued the launch and the event that closes its
    window, so that no timing window holds the card waiting for the host's
    launch path (the source's header says when it would).  Gates are
    numbered in one process; opening number n opens every gate up to n."""

    _lock = threading.Lock()
    _queue = None            # repro_gate(number, stream)
    _flag = None             # the int that opens them
    _count = 0

    @classmethod
    def queue(cls, device: torch.device) -> int:
        """A gate on ``device``'s current stream; returns its number."""
        import ctypes

        from repro_torch.kernels import common

        with cls._lock:
            if cls._queue is None:
                flag = getattr(common.load_library("gate.cu"),
                               "repro_gate_flag")
                flag.restype = ctypes.c_void_p
                address = flag()
                if not address:
                    raise RuntimeError("gate.cu could not map its flag")
                cls._flag = ctypes.c_int.from_address(address)
                cls._queue = common.entry("gate.cu", "repro_gate",
                                          [ctypes.c_int, ctypes.c_void_p])
            cls._count += 1
            number = cls._count
        rc = cls._queue(number, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gate launch failed: CUDA error {rc}")
        return number

    @classmethod
    def open(cls, number: int) -> None:
        with cls._lock:
            if cls._flag.value < number:
                cls._flag.value = number


class DeviceKernelEvaluator(Evaluator):
    """Live evaluator on the card: launch a registry kernel and time it.

    * runtime — the median of ``reps`` launches, each timed with CUDA events
      around the launch alone, after ``warmup`` launches, with the L2 cache
      flushed before each; each timed launch is held behind a gate
      (``_Gate``) until the host has queued it and its closing event;
    * PC_ops — the kernel's workload model ``bench.workload_fn(cfg, inp)``,
      with the hardware-true ``LOCAL_B`` spill of ``costmodel``;
    * PC_stress — each subsystem's modelled busy time over the measured
      runtime (``costmodel.stress_from_runtime``);
    * cost — the host wall-clock the test took.  The counters are derived,
      not collected in several profiling passes, so a profiled test costs
      its measured time like any other.

    ``device=None`` is the card, and ``hw=None`` its detected spec.
    ``device="cpu"`` runs the kernel's plain version, timed on the host
    clock, for the tests; its results carry ``device_name == "cpu"``.
    Every measurement is kept in ``measured``; ``recorded()`` turns an
    exhaustive sweep into a ``RecordedSpace``.
    """

    def __init__(self, space: TuningSpace, bench, inp: Any,
                 hw: Optional[HardwareSpec] = None, device=None,
                 reps: int = 5, warmup: int = 2):
        super().__init__(space)
        if reps < 1 or warmup < 0:
            raise ValueError(f"need reps >= 1 and warmup >= 0, got "
                             f"{reps}, {warmup}")
        bench.check_input(inp)
        self.device = resolve_device(device)
        self.bench = bench
        self.inp = inp
        self.reps = int(reps)
        self.warmup = int(warmup)
        if self.device.type == "cuda":
            self.device_name = torch.cuda.get_device_name(self.device)
            self.hw = hw if hw is not None else hwspec.detect(
                self.device.index)
            self._flush = torch.empty(L2_FLUSH_BYTES // 4,
                                      dtype=torch.float32,
                                      device=self.device)
        else:
            if hw is None:
                raise ValueError("a CPU evaluator needs hw=: there is no "
                                 "card to detect a spec from")
            self.device_name = "cpu"
            self.hw = hw
            self._flush = None
        self.args = bench.make_args(inp, np.random.default_rng(0),
                                    self.device)
        self.measured: Dict[int, CounterSet] = {}

    def _time(self, cfg: Config) -> float:
        with device_lock(self.device):
            return self._time_alone(cfg)

    def _time_alone(self, cfg: Config) -> float:
        run, args = self.bench.run, self.args
        if self._flush is None:
            for _ in range(self.warmup):
                run(cfg, *args)
            times = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                run(cfg, *args)
                times.append(time.perf_counter() - t0)
            return float(np.median(times))
        with torch.cuda.device(self.device):
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(self.reps)]
            for _ in range(self.warmup):
                run(cfg, *args)
            for start, end in events:
                self._flush.zero_()
                # the card waits here until the window is queued whole
                gate = _Gate.queue(self.device)
                try:
                    start.record()
                    run(cfg, *args)
                    end.record()
                finally:
                    _Gate.open(gate)
            torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events])) \
            * 1e-3

    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, Optional[CounterSet], float]:
        t0 = time.perf_counter()
        cfg = self.space[idx]
        rt = self._time(cfg)
        cs = costmodel.stress_from_runtime(
            self.bench.workload_fn(cfg, self.inp), self.hw, rt)
        self.measured[idx] = cs
        return rt, (cs if profiled else None), time.perf_counter() - t0

    def recorded(self) -> RecordedSpace:
        """The measurements as a ``RecordedSpace``; every configuration of
        the space must have been measured."""
        missing = len(self.space) - len(self.measured)
        if missing:
            raise ValueError(f"{missing} of {len(self.space)} configurations "
                             "have not been measured")
        counters = [self.measured[i] for i in range(len(self.space))]
        return RecordedSpace(
            space=self.space,
            runtimes=np.array([cs.runtime for cs in counters]),
            counters=counters, hw=self.hw,
            input_tag=f"{getattr(self.inp, 'tag', self.inp)}@"
                      f"{self.device_name}")


class ElasticInFlight:
    """Backpressure-driven target for outstanding empirical tests.

    Fixed-window search loops hold ``in_flight`` constant; this
    controller grows or shrinks the target between ``[lo, hi]`` from two
    observable signals:

    * **lane utilization** — the baseline target is the number of live
      lanes (fewer outstanding tests than lanes guarantees idle workers;
      queueing much deeper than the lanes only adds latency to feedback);
    * **measurement variance** — the coefficient of variation over a
      rolling window of per-test durations.  High variance means lanes
      free up unevenly, so a deeper queue is needed to keep the fast
      lanes from idling while a straggler holds its lane; near-constant
      durations need no queue beyond the lanes themselves.

    ``target(workers)`` = clamp(workers + ceil(cv · workers), lo, hi) —
    deterministic given the observation sequence, so elastic runs stay
    bit-reproducible on the virtual backends.  With ``lo == hi`` the
    controller degenerates to the fixed policy.
    """

    def __init__(self, lo: int, hi: int, window: int = 16):
        if lo < 1 or hi < lo:
            raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
        self.lo, self.hi = int(lo), int(hi)
        self._window = int(window)
        self._samples: List[float] = []

    def observe(self, duration: float) -> None:
        """Feed one per-test duration (cost or runtime) into the window."""
        if duration > 0.0 and np.isfinite(duration):
            self._samples.append(float(duration))
            if len(self._samples) > self._window:
                self._samples.pop(0)

    def cv(self) -> float:
        """Coefficient of variation over the current window (0 until two
        samples exist)."""
        if len(self._samples) < 2:
            return 0.0
        arr = np.asarray(self._samples)
        mean = float(arr.mean())
        if mean <= 0.0:
            return 0.0
        return float(arr.std() / mean)

    def target(self, workers: int) -> int:
        extra = int(np.ceil(self.cv() * max(1, int(workers))))
        return max(self.lo, min(self.hi, int(workers) + extra))


class VirtualAsyncEvaluator(Evaluator):
    """Simulated ``workers``-lane concurrency over any inner evaluator.

    ``submit`` dispatches each candidate to the earliest-free virtual
    worker; ``collect`` returns the earliest-*finishing* outstanding test,
    so completions come back out of submission order exactly as they would
    from a real device pool (a cheap config submitted after an expensive one
    finishes first).  Accounting goes through
    ``EvalAccount.record_completion``: the trace is ordered by completion
    time, ``elapsed`` is the completion frontier (wall-clock of a
    ``workers``-wide fleet), and ``busy`` is the familiar sum of per-test
    costs — with ``workers=1`` the two coincide and the behaviour degrades
    to the sequential evaluator's.

    The inner evaluator is used only for its pure ``_evaluate`` hook (all
    bookkeeping lives on THIS account); it must not be driven concurrently
    elsewhere.
    """

    def __init__(self, inner: Evaluator, workers: int = 4):
        super().__init__(inner.space)
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.inner = inner
        self.workers = int(workers)
        self._free = [0.0] * self.workers    # per-worker next-free time
        self._now = 0.0                      # time of the last collection
        self._heap: List[Tuple[float, int, Candidate, float,
                               Optional[CounterSet], float]] = []
        self._seq = 0

    def _evaluate(self, idx: int, profiled: bool
                  ) -> Tuple[float, Optional[CounterSet], float]:
        return self.inner._evaluate(idx, profiled)

    def submit(self, candidates: Sequence[Union[Candidate, int]]
               ) -> List[Ticket]:
        tickets = []
        for c in candidates:
            if not isinstance(c, Candidate):
                c = Candidate(int(c))
            rt, cs, cost = self.inner._evaluate(c.index, c.profile)
            if c.profile and cs is None:
                raise ProfilingUnsupported(
                    f"{type(self.inner).__name__} cannot collect "
                    "performance counters")
            w = min(range(self.workers), key=lambda i: self._free[i])
            start = max(self._now, self._free[w])
            finish = start + cost
            self._free[w] = finish
            heapq.heappush(self._heap, (finish, self._seq, c, rt, cs, cost))
            tickets.append(Ticket(uid=self._seq, candidate=c))
            self._seq += 1
        return tickets

    def collect(self, timeout: Optional[float] = None) -> List[Observation]:
        """Pop the earliest-finishing outstanding test ([] if none)."""
        if not self._heap:
            return []
        finish, _, c, rt, cs, cost = heapq.heappop(self._heap)
        self._now = max(self._now, finish)
        self.account.record_completion(c.index, rt, cost, finish)
        return [Observation(index=c.index, runtime=rt, counters=cs,
                            step=self.steps, elapsed=self.elapsed)]

    def outstanding(self) -> int:
        return len(self._heap)
