"""Shared evaluator protocol: the ask-tell side of empirical testing.

Every evaluator in the system — replayed records (``ReplayEvaluator``), the
analytic cost model (``CostModelEvaluator``), kernels launched and timed on
the card (``DeviceKernelEvaluator``) and timed callables
(``FunctionEvaluator``) — answers the same three questions:

  * ``measure(idx)``       — empirical test, runtime only (fast path);
  * ``profile(idx)``       — empirical test with performance counters
                             (slow path; optional — counter-less evaluators
                             raise ``ProfilingUnsupported``);
  * ``measure_many(batch)`` — evaluate a batch of ``Candidate``s, returning
                             ``Observation``s (the hook for async/parallel
                             tuning backends);
  * ``submit(batch)`` /
    ``collect()``           — the asynchronous form of the same protocol:
                             ``submit`` hands candidates to the evaluator
                             without waiting, ``collect`` returns finished
                             ``Observation``s (possibly out of submission
                             order).  The base class provides a synchronous
                             shim (submit queues, collect evaluates), so
                             every existing evaluator is already a valid —
                             if serial — async backend.

Accounting — steps, simulated wall-clock, per-step trace, best-so-far — is
the paper's primary metric and must be identical across evaluators, so it
lives in one place: ``EvalAccount``.  Searchers and the experiment harness
read it through public accessors (``steps``, ``trace``, ``history()``) and
never through evaluator internals.

Cost accounting under concurrency: ``elapsed`` is the completion-time
frontier (the wall-clock at which the latest finished test completed) and
``busy`` is the sum of per-test costs (worker-seconds).  A sequential
evaluator records through ``record`` where the two coincide; concurrent
backends record through ``record_completion`` in completion order, so the
trace stays sorted by *when results became known* — which is what
best-so-far convergence curves must be ordered by — rather than by
submission order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.counters import CounterSet
from repro_torch.core.tuning_space import TuningSpace


class ProfilingUnsupported(RuntimeError):
    """Raised by evaluators that cannot collect performance counters."""


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One proposed empirical test: which config, and whether to profile."""

    index: int
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class Observation:
    """Result of one empirical test, as delivered back to a searcher."""

    index: int
    runtime: float
    counters: Optional[CounterSet] = None   # present iff the test was profiled
    step: int = 0                           # evaluator step count after this test
    elapsed: float = 0.0                    # simulated tuning wall-clock so far


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Receipt for a submitted-but-not-yet-collected empirical test."""

    uid: int
    candidate: Candidate


@dataclasses.dataclass(frozen=True)
class AccountSnapshot:
    """Point-in-time (or delta) view of an ``EvalAccount``'s meters.

    ``EvalAccount.snapshot()`` freezes the current counters;
    ``EvalAccount.diff(since)`` subtracts an earlier snapshot, giving the
    steps / worker-seconds / abandoned cost accrued *between* the two — the
    metering primitive a multi-tenant scheduler charges budgets with
    (abandoned cost is part of ``busy``, so discarded attempts are billed
    too).  ``best_runtime``/``best_index`` are not deltas: they reflect the
    account's state at snapshot time.
    """

    steps: int
    elapsed: float
    busy: float              # worker-seconds (includes abandoned)
    abandoned: float         # worker-seconds of discarded attempts
    abandoned_count: int
    best_runtime: float
    best_index: Optional[int]


class EvalAccount:
    """Steps / elapsed / trace / best bookkeeping shared by all evaluators.

    ``trace`` is the paper's convergence record: (steps, elapsed, runtime)
    per empirical test.  ``history`` is the per-test (index, runtime) log in
    measurement order — the public replacement for peeking at private caches.
    """

    def __init__(self) -> None:
        self.steps: int = 0
        self.elapsed: float = 0.0
        self.busy: float = 0.0
        self.abandoned: float = 0.0       # worker-seconds of discarded work
        self.abandoned_count: int = 0     # discarded attempts
        self.trace: List[Tuple[int, float, float]] = []
        self.history: List[Tuple[int, float]] = []
        self.evaluated: Set[int] = set()
        self.best_runtime: float = float("inf")
        self.best_index: Optional[int] = None

    def _note(self, idx: int, runtime: float) -> None:
        self.evaluated.add(idx)
        if runtime < self.best_runtime:
            self.best_runtime = runtime
            self.best_index = idx
        self.history.append((idx, runtime))

    def record(self, idx: int, runtime: float, cost: float) -> None:
        """Sequential completion: the clock advances by the test's cost."""
        self.steps += 1
        self.elapsed += cost
        self.busy += cost
        self._note(idx, runtime)
        self.trace.append((self.steps, self.elapsed, runtime))

    def record_completion(self, idx: int, runtime: float, cost: float,
                          finished_at: float) -> None:
        """Concurrent completion at wall-clock ``finished_at``.

        Must be called in completion order (collect() guarantees this): the
        trace then stays sorted by when each result became known, so
        best-so-far curves are correct even when tests finish out of
        submission order.  ``elapsed`` advances to the completion frontier;
        ``cost`` accrues to ``busy`` (worker-seconds) only — under
        ``k``-way concurrency the wall-clock is NOT the sum of costs.
        """
        self.steps += 1
        self.elapsed = max(self.elapsed, float(finished_at))
        self.busy += cost
        self._note(idx, runtime)
        self.trace.append((self.steps, float(finished_at), runtime))

    def snapshot(self) -> AccountSnapshot:
        """Freeze the current meters (cheap; no trace/history copies)."""
        return AccountSnapshot(
            steps=self.steps, elapsed=self.elapsed, busy=self.busy,
            abandoned=self.abandoned, abandoned_count=self.abandoned_count,
            best_runtime=self.best_runtime, best_index=self.best_index)

    def diff(self, since: Optional[AccountSnapshot] = None
             ) -> AccountSnapshot:
        """Meters accrued since ``since`` (``None``: since creation).

        Counter fields (``steps``, ``busy``, ``abandoned``, ...) subtract;
        ``elapsed`` is the frontier advance; ``best_runtime``/``best_index``
        are the CURRENT values, not deltas.  This is how a tenant manager
        meters per-request worker-seconds off a live job account without
        monkeypatching the recording hooks — and because abandoned cost
        accrues into ``busy``, discarded attempts are charged too.
        """
        if since is None:
            return self.snapshot()
        return AccountSnapshot(
            steps=self.steps - since.steps,
            elapsed=self.elapsed - since.elapsed,
            busy=self.busy - since.busy,
            abandoned=self.abandoned - since.abandoned,
            abandoned_count=self.abandoned_count - since.abandoned_count,
            best_runtime=self.best_runtime, best_index=self.best_index)

    def record_abandoned(self, cost: float) -> None:
        """Work that was started and then discarded — a failed attempt
        that will be retried, or a straggler timed out and resubmitted
        elsewhere.  The worker-seconds were genuinely burned, so they
        accrue to ``busy`` (anything else under-reports the fleet's true
        cost), but the measurement produced no usable result: no step, no
        trace row, no best/history update.
        """
        self.busy += float(cost)
        self.abandoned += float(cost)
        self.abandoned_count += 1


class Evaluator:
    """Base class implementing the shared protocol over one ``_evaluate``.

    Subclasses implement ``_evaluate(idx, profiled) -> (runtime, counters,
    cost)`` where ``cost`` is the simulated (or real) wall-clock charged to
    this empirical test and ``counters`` may be None for unprofiled tests.
    """

    def __init__(self, space: TuningSpace):
        self.space = space
        self.account = EvalAccount()
        self._pending: List[Ticket] = []    # submitted, not yet collected
        self._ticket_uid = 0

    # -- accounting accessors (read-only views over the account) ---------------
    @property
    def steps(self) -> int:
        return self.account.steps

    @property
    def elapsed(self) -> float:
        return self.account.elapsed

    @property
    def busy(self) -> float:
        return self.account.busy

    @property
    def trace(self) -> List[Tuple[int, float, float]]:
        return self.account.trace

    @property
    def evaluated(self) -> Set[int]:
        return self.account.evaluated

    @property
    def best_runtime(self) -> float:
        return self.account.best_runtime

    @property
    def best_index(self) -> Optional[int]:
        return self.account.best_index

    def history(self) -> List[Tuple[int, float]]:
        """Per-test (config index, runtime) in measurement order."""
        return list(self.account.history)

    def __len__(self) -> int:
        return len(self.space)

    def exhausted(self) -> bool:
        return len(self.account.evaluated) >= len(self.space)

    # -- the protocol ----------------------------------------------------------
    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, Optional[CounterSet], float]:
        raise NotImplementedError

    def measure(self, idx: int) -> float:
        """Empirical test without counter collection (fast)."""
        rt, _, cost = self._evaluate(int(idx), False)
        self.account.record(int(idx), rt, cost)
        return rt

    def profile(self, idx: int) -> CounterSet:
        """Empirical test with counter collection (slow: multi-pass replay)."""
        rt, cs, cost = self._evaluate(int(idx), True)
        if cs is None:
            raise ProfilingUnsupported(
                f"{type(self).__name__} cannot collect performance counters")
        self.account.record(int(idx), rt, cost)
        return cs

    def measure_many(
        self, candidates: Sequence[Union[Candidate, int]]
    ) -> List[Observation]:
        """Evaluate a candidate batch; the extension point for parallelism."""
        out: List[Observation] = []
        for c in candidates:
            if not isinstance(c, Candidate):
                c = Candidate(int(c))
            if c.profile:
                cs = self.profile(c.index)
                rt = cs.runtime
            else:
                rt = self.measure(c.index)
                cs = None
            out.append(Observation(index=c.index, runtime=rt, counters=cs,
                                   step=self.steps, elapsed=self.elapsed))
        return out

    # -- asynchronous protocol (default synchronous shim) ----------------------
    def submit(self, candidates: Sequence[Union[Candidate, int]]
               ) -> List[Ticket]:
        """Hand candidates to the evaluator without waiting for results.

        The base implementation only queues them; real async backends
        override submit/collect to start work immediately.  Either way the
        contract is the same: every submitted candidate is eventually
        returned by ``collect`` exactly once, and accounting happens at
        collection (completion) time.
        """
        tickets = []
        for c in candidates:
            if not isinstance(c, Candidate):
                c = Candidate(int(c))
            t = Ticket(uid=self._ticket_uid, candidate=c)
            self._ticket_uid += 1
            self._pending.append(t)
            tickets.append(t)
        return tickets

    def collect(self, timeout: Optional[float] = None) -> List[Observation]:
        """Return finished observations for submitted candidates.

        The synchronous shim evaluates everything pending, in submission
        order, right now — which makes ``submit``+``collect`` through this
        shim bit-identical to ``measure_many`` (and hence the ``in_flight=1``
        event-driven search loop bit-identical to the sequential one).  Async
        backends instead block up to ``timeout`` for at least one completion
        and return observations in completion order.
        """
        pending, self._pending = self._pending, []
        return self.measure_many([t.candidate for t in pending])

    def outstanding(self) -> int:
        """Number of submitted-but-not-yet-collected empirical tests."""
        return len(self._pending)
