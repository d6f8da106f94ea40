"""``FleetTuner`` — many tuning jobs, one worker pool, one shared store.

The paper's value proposition is amortization: sample counters once,
converge fast on *other* inputs and *other* GPUs.  The fleet orchestrator
operationalizes that at deployment scale:

* every ``TuningJob`` (kernel × input bucket × hardware) gets its own
  ask-tell searcher and its own completion-ordered ``EvalAccount``; a
  priced job's tests are priced on the cost model, a measured job's
  launch and time its kernel on a card (``TuningJob.device``);
* one worker pool evaluates candidates from ALL jobs concurrently — when a
  job's searcher is between batches, its workers serve other jobs, so the
  fleet's wall-clock approaches ``total busy work / workers``;
* one concurrency-safe ``ConfigStore`` collects tuned configs and trained
  TP→PC_ops model artifacts under ``(space, bucket, hardware)`` keys;
* a job with no explicit searcher warm-starts from the NEAREST stored
  artifact (exact key → same bucket on other hardware → same hardware on
  another bucket → same space → compatible spaces, each rebound through
  the shared-counter intersection and blended as a similarity-weighted
  committee), walking the prior's predicted-runtime ranking on its own
  hardware — so adding a device or a shape to the fleet costs a handful
  of trials instead of a fresh search; a CROSS-SPACE prior additionally
  runs a distrust-and-verify first wave (``TransferredWarmStart``) so a
  misleading transfer costs at most one wave.  With no artifact at all
  the job falls back to its ``cold_searcher`` and, on completion, trains
  and publishes the missing model for the next arrival.

Scheduling is PRIORITY dispatch by predicted remaining gain: a job backed
by a stored TP→PC artifact knows its model-predicted best runtime on its
own hardware, so ``current best − predicted best`` estimates how much
latency further convergence is still buying; the scheduler spends lanes on
the job with the most left to gain (cold jobs with no artifact rank
highest — their gain is unknown).  Ties (and the all-cold fleet) break
least-recently-scheduled, which degenerates to the fair round-robin of
the pre-priority scheduler.  With ``park_factor`` set, a model-backed job
whose measured best is already within that factor of its predicted best is
PARKED — it stops consuming budget, freeing lanes for jobs still
converging — and is unparked if a model published later in the run shows
there was more gain to be had than its stale artifact predicted.

Failure handling (the fleet no longer dies on its first crashed config):
worker pools surface failed tests as ``FailedResult`` data, and the
orchestrator retries each failed test up to ``retries`` times on another
lane (exclude-and-resubmit).  A config whose measurement itself fails
``known_bad_after`` times is marked KNOWN-BAD: it resolves as an
``inf``-runtime row in the job's trace/history (so budgets terminate and
convergence curves stay honest) and is reported in ``JobResult.known_bad``.
With ``straggler_factor`` set, a test outstanding longer than that factor
times the job's rolling per-kind completion-latency estimate (submit →
finish on the pool clock, so IPC/queueing overhead is in the baseline) is
timed out: resubmitted elsewhere, and the eventual late result dropped.  Every discarded attempt's
worker-seconds are charged through ``EvalAccount.record_abandoned`` — they
appear in ``busy`` (and ``abandoned_s``) because the lanes really were
burned.

``in_flight`` may be ELASTIC: with ``in_flight_max`` set, an
``ElasticInFlight`` controller grows/shrinks the outstanding-work target
between the bounds from pool backpressure (live lane count) and the
variance of observed measurement costs.

This is the JAX package's fleet carried over: on the virtual pool the two
give the same per-job traces bit for bit.  Beside it, a job here may be
measured on the card, where the JAX fleet has only the cost model.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel, hwspec
from repro_torch.core.account import EvalAccount, Observation
from repro_torch.core.evaluate import ElasticInFlight
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.model import TPPCModel, TransferEnsemble
from repro_torch.core.searcher import (TransferredWarmStart,
                                       WarmStartSearcher, make_searcher)
from repro_torch.core.tuner import ensemble_runtime_scores, predicted_runtimes
from repro_torch.core.tuning_space import TuningSpace
from repro_torch.fleet.job import JobResult, TuningJob
from repro_torch.fleet.pool import FAIL_TEST, WorkItem

_INF = float("inf")

# Absolute floor on straggler deadlines: on real pools a sub-millisecond
# test can be delayed tens of milliseconds by OS scheduling/IPC jitter
# alone, which is noise, not straggling — never time out below this.
# Virtual clocks have no jitter and their test costs sit above the floor.
STRAGGLER_MIN_TIMEOUT = 0.05


def predicted_runtime_order(model: TPPCModel, space: TuningSpace,
                            hw: HardwareSpec) -> List[int]:
    """Config indices best-predicted-first: the portable model's PC_ops
    predictions priced through the cost model on the target hardware — the
    ranking a warm-started job walks."""
    return [int(i) for i in
            np.argsort(predicted_runtimes(model, space, hw), kind="stable")]


def _whole_space_scores(model, space: TuningSpace,
                        hw: HardwareSpec) -> np.ndarray:
    """Warm-start ranking scores for either prior shape: absolute
    predicted runtimes for a native/exact model, the committee's relative
    scores for a cross-space ``TransferEnsemble`` (only the argsort of
    the latter is meaningful — see ``ensemble_runtime_scores``)."""
    if isinstance(model, TransferEnsemble):
        return ensemble_runtime_scores(model, space, hw)
    return predicted_runtimes(model, space, hw)


@dataclasses.dataclass
class FleetReport:
    """What one ``FleetTuner.run()`` did, across all jobs."""

    results: List[JobResult]
    elapsed: float       # pool wall-clock consumed by this run (makespan)
    busy: float          # worker-seconds across all jobs (incl. abandoned)
    in_flight: int
    workers: int
    abandoned: float = 0.0       # worker-seconds of discarded attempts
    failures: int = 0            # failed attempts across all jobs
    timeouts: int = 0            # stragglers timed out and resubmitted
    known_bad: int = 0           # configs marked known-bad fleet-wide
    parked: int = 0              # jobs parked by the gain scheduler
    max_retries_used: int = 0    # highest attempt number any test needed
    in_flight_max: Optional[int] = None   # elastic upper bound (None: fixed)

    def by_job(self) -> Dict[str, JobResult]:
        return {r.job: r for r in self.results}


@dataclasses.dataclass
class _InFlight:
    """One logical empirical test currently on the pool."""

    js: "_JobState"
    index: int
    profile: bool
    attempt: int
    exclude: Tuple[int, ...]
    submitted_at: float      # absolute pool clock at submission


class _TrainerThread:
    """Background executor for the fleet's model work.

    Two task kinds ride the same bounded queue: **prep** (warm-start
    whole-space prediction for a job about to bind its searcher) and
    **train** (the TP→PC model a finished cold job publishes).  Both are
    pure compute over read-only inputs — every store read/write stays on
    the event-loop thread, which applies completions via ``get``.  A
    task that raises is delivered as an error, never as a dead thread:
    the loop contains the failure to that one job/publish and keeps
    dispatching (trainer-crash containment).
    """

    def __init__(self, maxsize: int = 8):
        self._in: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._out: "queue.Queue" = queue.Queue()
        # submitted-not-yet-applied; touched only by the loop thread
        self.pending = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-trainer", daemon=True)
        self._thread.start()

    def submit(self, tag: str, js: "_JobState",
               fn: Callable[[], Any]) -> None:
        """Enqueue one task (blocks when the bounded queue is full —
        backpressure on a loop outrunning the trainer)."""
        self.pending += 1
        self._in.put((tag, js, fn))

    def _loop(self) -> None:
        while True:
            task = self._in.get()
            if task is None:
                return
            tag, js, fn = task
            try:
                self._out.put((tag, js, fn(), None))
            except BaseException as exc:
                self._out.put((tag, js, None, exc))

    def get(self, block: bool = False, timeout: Optional[float] = None):
        """One ``(tag, js, result, error)`` completion, or None when
        nothing is ready within the wait."""
        try:
            if block:
                item = self._out.get(timeout=timeout)
            else:
                item = self._out.get_nowait()
        except queue.Empty:
            return None
        self.pending -= 1
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._in.put(None)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)


class _JobState:
    """Orchestrator-side bookkeeping for one job."""

    def __init__(self, job: TuningJob):
        self.job = job
        self.account = EvalAccount()
        self.searcher = None
        self.searcher_name = ""
        self.warm_started = False
        # warm-start prep pipeline: None (not started) -> "pending"
        # (whole-space prediction on the trainer thread) -> "done"
        self.prep_state: Optional[str] = None
        self.prep_model = None
        self.prep_key: Optional[str] = None
        self.pred = None
        # cross-space transfer provenance (set when the warm start came
        # from the store's compatible-space tier)
        self.transfer_key: Optional[str] = None
        self.transfer_similarity: Optional[float] = None
        # store key of the exact-space artifact a warm start walks
        self.warm_key: Optional[str] = None
        self.submitted = 0
        self.pending = 0
        self.done = False
        self.result: Optional[JobResult] = None
        self.hw = job.hw_spec()
        self.hw_key = job.hardware_key
        # fault-tolerance / scheduling state
        self.retry_queue: List[Tuple[int, bool, int, Tuple[int, ...]]] = []
        self.fail_counts: Dict[int, int] = {}
        self.known_bad: List[int] = []
        self.failures = 0
        self.timeouts = 0
        # rolling per-kind completion-LATENCY window (submit→finish on
        # the pool clock, so IPC/queueing overhead is part of the
        # baseline; profiled tests are ~5x plain, so one shared window
        # would false-flag every profile as a straggler)
        self.lat_window: Dict[bool, List[float]] = {False: [], True: []}
        self.predicted_best: Optional[float] = None
        self.parked = False
        self.was_parked = False
        self.last_pick = 0

    def payload_for(self, index: int, profile: bool) -> Optional[dict]:
        if self.job.kernel is None:
            return None
        p = {"kernel": self.job.kernel, "input": self.job.input_key,
             "index": int(index), "profile": bool(profile)}
        if self.job.measured:
            p["measure"] = True     # only a lane with a device takes it
        if self.hw_key in hwspec.SPECS:
            p["hw"] = self.hw_key
        else:
            # fingerprint keys aren't resolvable by name on the worker
            # side — ship the spec's declared numbers instead
            p["hw_spec"] = dataclasses.asdict(self.hw)
        return p

    def note_latency(self, profile: bool, latency: float) -> None:
        w = self.lat_window[profile]
        w.append(latency)
        if len(w) > 8:
            w.pop(0)

    def latency_estimate(self, profile: bool) -> Optional[float]:
        """Straggler baseline: the MAX over the recent latency window —
        real pools see scheduling/IPC hiccups far above the median, and a
        mean-style estimate false-flags them; armed only after 3
        completions of the kind so one early sample can't set a hair
        trigger.  ``None`` disarms the timeout for this (job, kind)."""
        w = self.lat_window[profile]
        if len(w) < 3:
            return None
        return max(w)


class FleetTuner:
    """Schedule many ``TuningJob``s over one pool and one shared store.

    ``in_flight`` defaults to the pool's worker count — more keeps lanes
    busy across searcher latencies, fewer throttles; ``in_flight_max``
    makes it elastic between the two bounds.  ``publish_models`` makes cold
    jobs train and store the portable TP→PC_ops model for their key on
    completion (the artifact later arrivals warm-start from).

    Fault policy: ``retries`` bounds resubmissions per logical test;
    ``known_bad_after`` measurement failures of one config mark it
    known-bad; ``straggler_factor`` (None: disabled) times out tests
    outstanding longer than ``factor ×`` the job's rolling cost estimate.
    ``park_factor`` (None: disabled) parks model-backed jobs whose best is
    already within that factor of their predicted best runtime.
    """

    def __init__(self, jobs: Sequence[TuningJob], pool,
                 store=None,
                 in_flight: Optional[int] = None,
                 publish_models: bool = True,
                 model_kind: str = "tree",
                 verbose: bool = False,
                 retries: int = 2,
                 known_bad_after: int = 2,
                 straggler_factor: Optional[float] = None,
                 park_factor: Optional[float] = None,
                 in_flight_max: Optional[int] = None,
                 allow_empty: bool = False,
                 on_job_done=None,
                 on_trial=None,
                 train_async: bool = True,
                 train_queue: int = 8,
                 transfer: bool = True,
                 transfer_threshold: Optional[float] = None):
        if not jobs and not allow_empty:
            raise ValueError("FleetTuner needs at least one job "
                             "(allow_empty=True for a service fleet that "
                             "injects jobs while running)")
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"job names must be unique, got {names}")
        self.jobs = list(jobs)
        self.pool = pool
        self.store = store
        self.in_flight = int(in_flight if in_flight is not None
                             else pool.workers)
        if in_flight_max is not None and in_flight_max < self.in_flight:
            raise ValueError(
                f"in_flight_max must be >= in_flight, got "
                f"{in_flight_max} < {self.in_flight}")
        self.in_flight_max = in_flight_max
        self.publish_models = publish_models
        self.model_kind = model_kind
        self.verbose = verbose
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = int(retries)
        self.known_bad_after = int(known_bad_after)
        self.straggler_factor = straggler_factor
        self.park_factor = park_factor
        self.on_job_done = on_job_done
        # fires after EVERY resolved empirical test with
        # (job_name, trials_so_far, best_runtime) — the service journals
        # these as progress checkpoints so a crashed daemon resumes an
        # interrupted job with only its REMAINING budget
        self.on_trial = on_trial
        self._uid = 0
        self._states: List[_JobState] = []
        self._by_name: Dict[str, _JobState] = {}
        self._inflight: Dict[int, _InFlight] = {}
        self._abandoned: Dict[int, _JobState] = {}
        self._pick_seq = 0
        self._max_attempt = 0
        self._began = False
        self._stopping = False
        self._t_start = 0.0
        self._elastic: Optional[ElasticInFlight] = None
        self._limit = self.in_flight
        # off-loop model training: warm-start prediction and
        # publish-time training run on a trainer thread; the loop keeps
        # dispatching and applies completions between ticks
        self.train_async = bool(train_async)
        self.train_queue = int(train_queue)
        self._trainer: Optional[_TrainerThread] = None
        self.train_errors: List[Tuple[str, str]] = []
        # cross-space model transfer: when ALL exact-space warm-start
        # tiers miss, try the store's signature-indexed compatible-space
        # tier before going cold (transfer=False pins the legacy ladder)
        self.transfer = bool(transfer)
        if transfer_threshold is None:
            from repro_torch.tuning.signature import DEFAULT_TRANSFER_THRESHOLD
            transfer_threshold = DEFAULT_TRANSFER_THRESHOLD
        self.transfer_threshold = float(transfer_threshold)
        # (space, kind) -> publishes still training: jobs of that space
        # defer binding until the model they would have seen is out
        self._publish_keys: Dict[Tuple[str, str], int] = {}

    # -- per-job setup ---------------------------------------------------------
    def _start(self, js: _JobState) -> bool:
        """Bind a searcher on first schedule: explicit name, or warm-start
        from the nearest stored artifact, or the cold fallback.  A loaded
        model also prices the job's predicted best runtime — the gain
        estimate the priority scheduler and parking policy run on.

        Returns False while the job is NOT yet schedulable: its
        whole-space warm-start prediction is still on the trainer
        thread, or a model publish for its (space, kind) is still
        training (binding now would miss the artifact the synchronous
        path would have seen).  The caller skips the job this tick and
        the fleet keeps dispatching other work meanwhile."""
        if js.searcher is not None:
            return True
        t0 = self.pool.elapsed()
        job = js.job
        if js.prep_state == "pending":
            return False
        if js.prep_state is None:
            if self._trainer is not None and self._publish_keys.get(
                    (job.space.name, job.kind), 0) > 0:
                return False
            model, key = (None, None)
            if self.store is not None:
                model, key = self.store.load_nearest_model(
                    job.space.name, job.bucket, js.hw_key,
                    bind_space=job.space, kind=job.kind)
            if model is None and job.searcher is None:
                # all four exact-space tiers missed: try the store's
                # signature-indexed compatible-space tier (a model from
                # a structurally similar space, rebound through the
                # shared-counter intersection)
                model, key = self._load_transfer(js)
            js.prep_model, js.prep_key = model, key
            if model is not None and self._trainer is not None:
                space, hw = job.space, js.hw
                js.prep_state = "pending"
                self._trainer.submit(
                    "prep", js,
                    lambda: _whole_space_scores(model, space, hw))
                return False
            if model is not None:
                js.pred = _whole_space_scores(model, job.space, js.hw)
            js.prep_state = "done"
        model, pred = js.prep_model, js.pred
        if model is not None and pred is not None:
            if js.transfer_key is None:
                # a borrowed model's ABSOLUTE scale is not trustworthy on
                # a space it was never fit on: transferred jobs keep gain
                # unknown (rank like cold, never park on the prior)
                js.predicted_best = float(np.min(pred))
            if self.verbose:
                print(f"[fleet] {job.name}: warm start from {js.prep_key}")
        if job.searcher is not None:
            js.searcher_name = job.searcher
            js.searcher = make_searcher(
                job.searcher, job.space, seed=job.seed,
                model=model, cores=js.hw.sms)
        elif model is not None and pred is not None:
            js.warm_started = True
            order = [int(i) for i in np.argsort(pred, kind="stable")]
            if js.transfer_key is not None:
                # transferred prior: distrust-and-verify first wave, so
                # a misleading cross-space ranking costs at most one wave
                js.searcher_name = "transfer_warm_start"
                js.searcher = TransferredWarmStart(
                    job.space, order=order, seed=job.seed)
            else:
                js.searcher_name = "warm_start"
                js.warm_key = js.prep_key
                js.searcher = WarmStartSearcher(
                    job.space, order=order, seed=job.seed)
        else:
            # going cold: any transfer candidacy died in prep (failed
            # whole-space prediction) — drop the provenance with it
            js.transfer_key = None
            js.transfer_similarity = None
            js.searcher_name = job.cold_searcher
            js.searcher = make_searcher(job.cold_searcher, job.space,
                                        seed=job.seed)
        js.prep_model = None          # the searcher owns it from here
        js.pred = None
        self._absorb_stall(t0)
        return True

    def _load_transfer(self, js: _JobState):
        """Compatible-space prior for a job every exact tier missed:
        sign the job's space (counters sampled from one pure workload
        evaluation) and ask the store for the similarity-weighted
        committee over EVERY same-kind artifact above the threshold
        (``load_transfer_ensemble``; a store exposing only the single
        best via ``load_transfer_model`` still works).  Provenance
        reports the top member.  Failures are contained to this job
        (recorded in ``train_errors``) — it just goes cold, exactly as
        if the tier had missed."""
        if not self.transfer or self.store is None \
                or not (hasattr(self.store, "load_transfer_ensemble")
                        or hasattr(self.store, "load_transfer_model")):
            return None, None
        job = js.job
        try:
            from repro_torch.tuning.signature import SpaceSignature

            counters = ()
            if job.workload_fn is not None and len(job.space):
                counters = sorted(job.workload_fn(job.space[0]))
            sig = SpaceSignature.from_space(job.space, kind=job.kind,
                                            counters=counters)
            loader = getattr(self.store, "load_transfer_ensemble",
                             self.store.load_transfer_model)
            model, key, sim = loader(
                sig, job.bucket, js.hw_key, bind_space=job.space,
                threshold=self.transfer_threshold)
        except Exception as exc:
            self.train_errors.append((job.name, f"transfer: {exc!r}"))
            if self.verbose:
                print(f"[fleet] {job.name}: transfer lookup failed "
                      f"({exc!r}); going cold")
            return None, None
        if model is None:
            return None, None
        js.transfer_key = key
        js.transfer_similarity = float(sim)
        if self.verbose:
            n = len(model) if isinstance(model, TransferEnsemble) else 1
            print(f"[fleet] {job.name}: cross-space transfer from {key} "
                  f"(similarity {sim:.3f}, committee of {n})")
        return model, key

    def _apply_prep(self, js: _JobState, pred, error) -> None:
        """Trainer completion for a warm-start prediction (loop thread).
        A failed prediction falls back to the cold searcher — contained
        to this job, recorded, never fatal to the loop."""
        if error is not None:
            self.train_errors.append((js.job.name, f"prep: {error!r}"))
            if self.verbose:
                print(f"[fleet] {js.job.name}: warm-start prep failed "
                      f"({error!r}); going cold")
            js.prep_model = None
            pred = None
        js.pred = pred
        js.prep_state = "done"

    def _eval_fn(self, js: _JobState, index: int, profile: bool):
        """Measurement closure for in-process pools.  A priced job's
        portable workload is priced through the cost model on its hardware,
        with the replay cost structure (profiled tests pay the multi-pass
        slowdown); a measured job's test goes to the card's evaluator (its
        ``eval_fn``, ``job.measure_fn``), never to the cost model."""
        from repro_torch.core.evaluate import (PROFILE_FIXED,
                                               PROFILE_SLOWDOWN,
                                               TEST_OVERHEAD)

        if js.job.eval_fn is not None:
            custom = js.job.eval_fn
            return lambda: custom(index, profile)
        if js.job.measured:
            raise ValueError(f"job {js.job.name} measures on "
                             f"{js.job.device} but has no eval_fn: build "
                             "it with job_from_registry(device=...)")

        space, wl, hw = js.job.space, js.job.workload_fn, js.hw

        def fn():
            cs = costmodel.execute(wl(space[index]), hw)
            rt = float(cs.runtime)
            if profile:
                return rt, cs, rt * PROFILE_SLOWDOWN + TEST_OVERHEAD \
                    + PROFILE_FIXED
            return rt, None, rt + TEST_OVERHEAD

        return fn

    def _absorb_stall(self, t0: float) -> None:
        """True orchestrator work (store put/save at finalize, searcher
        binding) stalls the event loop while in-flight tests keep aging
        on the real pool clock — their results may already sit
        uncollected in the queue.  Shift their submission stamps by the
        stall so the straggler timeout only measures time the POOL
        spent, not time we did.  The former big offenders — model
        training at finalize, whole-space prediction at warm start —
        now run on the trainer thread and no longer stall the loop at
        all (``train_async=False`` restores the inline behavior, still
        covered here).  (Virtual pools don't advance during orchestrator
        work, so this is a no-op there.)
        """
        stall = self.pool.elapsed() - t0
        if stall > 0.0:
            for info in self._inflight.values():
                info.submitted_at += stall

    # -- scheduling ------------------------------------------------------------
    def _alive(self) -> int:
        alive = getattr(self.pool, "alive_workers", None)
        return int(alive()) if alive is not None else int(self.pool.workers)

    def _priority(self, js: _JobState) -> float:
        """Predicted remaining gain: how much latency convergence is still
        buying this job.  Cold jobs (no artifact) rank highest — their gain
        is unknown, and exploring them also produces the artifacts that
        sharpen everyone else's estimate."""
        if js.predicted_best is None:
            return _INF
        return max(0.0, js.account.best_runtime - js.predicted_best)

    def _pick(self, skip: set) -> Optional[_JobState]:
        """Highest-gain schedulable job; ties break least-recently-picked
        (which reduces to fair round-robin for an all-cold fleet)."""
        best, best_key = None, None
        for js in self._states:
            if js.done or js.parked or js in skip:
                continue
            if not js.retry_queue and js.submitted >= js.job.budget:
                continue
            key = (self._priority(js), -js.last_pick)
            if best is None or key > best_key:
                best, best_key = js, key
        return best

    def _submit(self, js: _JobState, index: int, profile: bool,
                attempt: int, exclude: Tuple[int, ...]) -> None:
        uid = self._uid
        self._uid += 1
        self._max_attempt = max(self._max_attempt, attempt)
        self._inflight[uid] = _InFlight(
            js=js, index=index, profile=profile, attempt=attempt,
            exclude=exclude, submitted_at=self.pool.elapsed())
        self.pool.submit(WorkItem(
            uid=uid, job=js.job.name, index=index, profile=profile,
            fn=self._eval_fn(js, index, profile),
            payload=js.payload_for(index, profile),
            attempt=attempt, exclude=exclude))

    def _fill(self, limit: int) -> None:
        """Saturate the pool up to ``limit`` logical tests, highest
        predicted gain first; retries of failed tests go out before new
        candidates of the same job."""
        skip: set = set()
        while len(self._inflight) < limit:
            js = self._pick(skip)
            if js is None:
                return
            if js.retry_queue:
                index, profile, attempt, exclude = js.retry_queue.pop(0)
                self._submit(js, index, profile, attempt, exclude)
                js.last_pick = self._next_pick()
                continue
            if not self._start(js):
                # warm-start prep (or a blocking publish) still on the
                # trainer thread: other jobs get the lanes meanwhile
                skip.add(js)
                continue
            cands = js.searcher.propose(1)
            if not cands:
                # waiting on its batch (pending > 0) or exhausted
                if js.pending == 0 and js.searcher.done:
                    self._finalize(js)
                skip.add(js)
                continue
            c = cands[0]
            self._submit(js, c.index, c.profile, 0, ())
            js.submitted += 1
            js.pending += 1
            js.last_pick = self._next_pick()

    def _next_pick(self) -> int:
        self._pick_seq += 1
        return self._pick_seq

    # -- completion handling ---------------------------------------------------
    def _resolve(self, js: _JobState, index: int, runtime: float,
                 counters, cost: float, finished_rel: float) -> None:
        """One logical test reached its final outcome (measured result or
        known-bad ``inf``): account it, feed the searcher, re-evaluate
        parking, finalize on budget exhaustion."""
        js.pending -= 1
        # job accounts run on THIS run's clock (the pool may have served
        # earlier runs), so per-job elapsed stays comparable to the
        # report's makespan
        js.account.record_completion(index, runtime, cost, finished_rel)
        js.searcher.observe([Observation(
            index=index, runtime=runtime, counters=counters,
            step=js.account.steps, elapsed=js.account.elapsed)])
        if self.on_trial is not None:
            self.on_trial(js.job.name, js.account.steps,
                          js.account.best_runtime)
        self._maybe_park(js)
        if js.pending == 0 and js.submitted >= js.job.budget:
            self._finalize(js)

    def _handle(self, res, t_start: float) -> None:
        info = self._inflight.pop(res.uid, None)
        if info is None:
            # a timed-out straggler finally came back: its measurement is
            # discarded, but the lane-seconds it burned are real
            js = self._abandoned.pop(res.uid, None)
            if js is not None:
                js.account.record_abandoned(res.cost)
            return
        js = info.js
        finished_rel = res.finished_at - t_start
        if res.error is None:
            # latency, not in-worker cost: for subprocess/thread pools the
            # submit→finish time includes IPC and queueing, and THAT is
            # what a straggler deadline must be calibrated against
            latency = res.finished_at - info.submitted_at
            js.note_latency(info.profile,
                            latency if latency > 0.0 else res.cost)
            self._resolve(js, res.index, res.runtime, res.counters,
                          res.cost, finished_rel)
            return
        # -- failure: the attempt burned a lane but produced nothing
        js.failures += 1
        js.account.record_abandoned(res.cost)
        kind = res.kind or FAIL_TEST
        give_up = False
        if kind == FAIL_TEST:
            js.fail_counts[info.index] = \
                js.fail_counts.get(info.index, 0) + 1
            if js.fail_counts[info.index] >= self.known_bad_after:
                give_up = True        # the config itself is the problem
        if not give_up and info.attempt < self.retries \
                and self._alive() > 0:
            exclude = info.exclude
            if res.lane >= 0 and res.lane not in exclude:
                exclude = exclude + (res.lane,)
            js.retry_queue.append(
                (info.index, info.profile, info.attempt + 1, exclude))
            if self.verbose:
                print(f"[fleet] {js.job.name}[{info.index}] failed "
                      f"({kind}): retry {info.attempt + 1}")
            return
        # give up: resolve the test as an inf row so the budget terminates
        # and the searcher is unblocked; the known-bad label is reserved
        # for configs whose OWN measurement failed known_bad_after times —
        # a retry budget exhausted on lane faults (or on a smaller fail
        # count) doesn't condemn the config
        if kind == FAIL_TEST \
                and js.fail_counts.get(info.index, 0) \
                >= self.known_bad_after \
                and info.index not in js.known_bad:
            js.known_bad.append(info.index)
        if self.verbose:
            print(f"[fleet] {js.job.name}[{info.index}] failed "
                  f"({kind}): giving up ({res.error})")
        self._resolve(js, info.index, _INF, None, 0.0, finished_rel)

    def _check_stragglers(self, t_start: float) -> None:
        """Time out tests outstanding longer than ``straggler_factor ×``
        their job's rolling latency estimate: resubmit elsewhere and drop
        the eventual late result (its cost is charged on arrival).  The
        retry carries no lane exclusion (the straggler's lane is unknown
        until its result arrives), but both addressable pools steer it
        away anyway: the wedged lane still holds the hung test in its
        busy/next-free accounting, so least-loaded selection avoids it."""
        if self.straggler_factor is None:
            return
        now = self.pool.elapsed()
        for uid, info in list(self._inflight.items()):
            est = info.js.latency_estimate(info.profile)
            if est is None:
                continue
            allowed = max(self.straggler_factor * est,
                          STRAGGLER_MIN_TIMEOUT)
            if now - info.submitted_at <= allowed:
                continue
            del self._inflight[uid]
            self._abandoned[uid] = info.js
            js = info.js
            js.timeouts += 1
            if self.verbose:
                print(f"[fleet] {js.job.name}[{info.index}] straggling "
                      f"(> {self.straggler_factor:.1f}x est): resubmit")
            if info.attempt < self.retries:
                js.retry_queue.append(
                    (info.index, info.profile, info.attempt + 1,
                     info.exclude))
            else:   # out of retries: resolve without a measurement
                self._resolve(js, info.index, _INF, None, 0.0,
                              now - t_start)

    def _collect_tick(self) -> Optional[float]:
        """Block-until for ``collect``: the nearest straggler deadline
        (None blocks indefinitely — no timeout policy or no estimate yet).
        Virtual pools ignore it; real pools wake up to run the scan."""
        if self.straggler_factor is None:
            return None
        deadlines = []
        for info in self._inflight.values():
            est = info.js.latency_estimate(info.profile)
            if est is not None:
                deadlines.append(
                    info.submitted_at + max(self.straggler_factor * est,
                                            STRAGGLER_MIN_TIMEOUT))
        if not deadlines:
            return None
        return max(0.01, min(deadlines) - self.pool.elapsed() + 0.01)

    # -- the event loop --------------------------------------------------------
    # ``run()`` is the one-shot form; a long-lived service instead drives
    # ``begin()`` / ``step()`` / ``finish()`` itself so it can inject
    # (``add_job``) and cancel (``cancel_job``) jobs between ticks.  The
    # decomposition is behavior-preserving: ``run()`` is exactly
    # begin + step-until-idle + finish.
    def begin(self) -> None:
        """Initialize a (possibly empty) scheduling session."""
        self._states = [_JobState(j) for j in self.jobs]
        self._by_name = {js.job.name: js for js in self._states}
        for i, js in enumerate(self._states):
            js.last_pick = i      # initial tie-break: declaration order
        self._pick_seq = len(self._states)
        self._inflight = {}
        self._abandoned = {}
        self._t_start = self.pool.elapsed()
        self._elastic = None
        if self.in_flight_max is not None:
            self._elastic = ElasticInFlight(lo=self.in_flight,
                                            hi=self.in_flight_max)
        self._limit = self.in_flight
        self._stopping = False
        if self.train_async and self._trainer is None:
            self._trainer = _TrainerThread(maxsize=self.train_queue)
        self._publish_keys = {}
        self._began = True

    def add_job(self, job: TuningJob) -> None:
        """Inject a job — before ``begin()`` or into a RUNNING fleet.

        Mid-run injection is the service path: the new job competes for
        lanes under the same gain-priority scheduler from the next
        ``step()`` (cold jobs rank highest, so a fresh tenant is served
        promptly without preempting in-flight work).
        """
        if any(j.name == job.name for j in self.jobs):
            raise ValueError(f"duplicate job name {job.name!r}")
        self.jobs.append(job)
        if self._began:
            js = _JobState(job)
            js.last_pick = self._next_pick()
            self._states.append(js)
            self._by_name[job.name] = js

    def cancel_job(self, name: str) -> bool:
        """Cancel a job mid-run: queued retries are dropped, in-flight
        tests are reclassified as abandoned (their lane-seconds are still
        charged when they come back), and the job resolves immediately to
        a partial ``JobResult`` with ``cancelled=True``.  Nothing is
        published to the store.  Returns False if unknown or already done.
        """
        js = self._by_name.get(name)
        if js is None or js.done:
            return False
        js.retry_queue.clear()
        for uid, info in list(self._inflight.items()):
            if info.js is js:
                del self._inflight[uid]
                self._abandoned[uid] = js
        js.pending = 0
        self._resolve_cancelled(js)
        return True

    def stop(self) -> None:
        """Graceful drain: stop scheduling NEW tests; in-flight tests keep
        running and are collected/accounted by the remaining ``step()``s
        (the shared shutdown path of the fleet CLI and the daemon)."""
        self._stopping = True

    @property
    def stopping(self) -> bool:
        return self._stopping

    def step(self, max_wait: Optional[float] = None) -> bool:
        """One scheduling tick: saturate the pool, collect one completion,
        process stragglers.  Returns False when the fleet is idle (nothing
        in flight and nothing schedulable) — the moment a service waits for
        new requests and ``run()`` finishes.  ``max_wait`` bounds how long
        the tick may block on the pool (None: until the next straggler
        deadline, or indefinitely), so a driving loop stays responsive to
        injected jobs and shutdown signals.
        """
        self._drain_trainer()
        if not self._stopping:
            self._fill(self._limit)
        if not self._inflight:
            if self._trainer is not None and self._trainer.pending > 0:
                # nothing on the pool, but searchers/models are still
                # training: wait for one completion so it can unblock
                # scheduling, and report the fleet as busy
                self._drain_trainer(block=True, max_wait=max_wait)
                return True
            return False
        tick = self._collect_tick()
        if max_wait is not None:
            tick = max_wait if tick is None else min(tick, max_wait)
        try:
            res = self.pool.collect(timeout=tick)
        except queue.Empty:
            self._check_stragglers(self._t_start)
            return True
        self._handle(res, self._t_start)
        if self._elastic is not None:
            if res.error is None:
                self._elastic.observe(res.cost)
            self._limit = self._elastic.target(self._alive())
        self._check_stragglers(self._t_start)
        return True

    def _drain_trainer(self, block: bool = False,
                       max_wait: Optional[float] = None) -> None:
        """Apply ready trainer completions on the loop thread (binds
        searchers, publishes models).  ``block=True`` waits up to
        ``max_wait`` for the first one; the rest drain opportunistically.
        """
        if self._trainer is None:
            return
        while self._trainer.pending > 0:
            item = self._trainer.get(block=block, timeout=max_wait)
            if item is None:
                return
            block = False
            tag, js, out, err = item
            if tag == "prep":
                self._apply_prep(js, out, err)
            else:
                self._apply_publish(js, out, err)

    def _drain_trainer_all(self) -> None:
        """Block until every outstanding trainer task has been applied
        (finish-time barrier: published models must be in the store
        before the report returns, so a later run warm-starts)."""
        if self._trainer is None:
            return
        while self._trainer.pending > 0:
            item = self._trainer.get(block=True, timeout=30.0)
            if item is None:          # wedged trainer: don't hang finish
                break
            tag, js, out, err = item
            if tag == "prep":
                self._apply_prep(js, out, err)
            else:
                self._apply_publish(js, out, err)

    def finish(self) -> FleetReport:
        """Drain straggler debts, finalize every remaining job, and build
        the report for everything since ``begin()``."""
        self._drain_trainer_all()
        # drain abandoned stragglers still on the pool so their burned
        # lane-seconds are charged (and a reused pool starts clean);
        # a straggler that never returns (hung thread) is skipped
        while self._abandoned and self.pool.outstanding() > 0:
            try:
                res = self.pool.collect(timeout=0.05)
            except queue.Empty:
                break
            js = self._abandoned.pop(res.uid, None)
            if js is not None:
                js.account.record_abandoned(res.cost)
        for js in self._states:   # parked jobs + searchers that dried up
            if not js.done:
                self._finalize(js)
        # finalizing above may have queued publish trainings; they must
        # land before the report so the next run's warm starts see them
        self._drain_trainer_all()
        # the trainer thread ends with the run — ``begin()`` starts a
        # fresh one, so a finished tuner never leaks a parked thread
        # into the embedding process (one daemon per process is the
        # norm, but benchmarks and tests cycle many)
        if self._trainer is not None:
            self._trainer.close()
            self._trainer = None
        for js in self._states:
            # a straggler drained above may have charged abandoned cost
            # AFTER its job finalized — refresh the snapshot's accounting
            js.result.busy = js.account.busy
            js.result.abandoned_s = js.account.abandoned
        results = [js.result for js in self._states]
        return FleetReport(
            results=results,
            elapsed=self.pool.elapsed() - self._t_start,
            busy=float(sum(r.busy for r in results)),
            in_flight=self.in_flight,
            workers=self.pool.workers,
            abandoned=float(sum(r.abandoned_s for r in results)),
            failures=int(sum(r.failures for r in results)),
            timeouts=int(sum(js.timeouts for js in self._states)),
            known_bad=int(sum(len(r.known_bad) for r in results)),
            parked=int(sum(1 for r in results if r.parked)),
            max_retries_used=self._max_attempt,
            in_flight_max=self.in_flight_max)

    def run(self) -> FleetReport:
        self.begin()
        while self.step():
            pass
        return self.finish()

    # -- introspection (the service's metering hooks) --------------------------
    def job_account(self, name: str) -> Optional[EvalAccount]:
        """The LIVE account of one job (None: unknown) — what a tenant
        manager snapshots/diffs to meter per-request worker-seconds."""
        js = self._by_name.get(name)
        return js.account if js is not None else None

    def progress(self) -> Dict[str, float]:
        """Fleet-wide meters since ``begin()`` (cheap, callable mid-run)."""
        busy = float(sum(js.account.busy for js in self._states))
        elapsed = self.pool.elapsed() - self._t_start
        return {
            "jobs": len(self._states),
            "jobs_done": sum(1 for js in self._states if js.done),
            "in_flight": len(self._inflight),
            "busy_s": busy,
            "elapsed_s": elapsed,
            "utilization": busy / max(elapsed * self.pool.workers, 1e-12),
        }

    # -- parking ---------------------------------------------------------------
    def _maybe_park(self, js: _JobState) -> None:
        """Park a model-backed job whose measured best already sits within
        ``park_factor`` of its predicted best: convergence has stopped
        buying latency, so its budget goes to jobs still gaining."""
        if (self.park_factor is None or js.parked
                or js.predicted_best is None):
            return
        if js.account.best_runtime <= self.park_factor * js.predicted_best:
            js.parked = True
            js.was_parked = True
            if self.verbose:
                print(f"[fleet] {js.job.name}: parked at "
                      f"{js.account.best_runtime * 1e3:.3f}ms "
                      f"(predicted best "
                      f"{js.predicted_best * 1e3:.3f}ms)")

    def _unpark_check(self, space_name: str,
                      kind: str = "kernel") -> None:
        """A model was just published for ``space_name``: parked jobs of
        that space (same problem kind) re-price their predicted best
        against the now-nearest artifact, and unpark if it shows more
        remaining gain than the stale artifact they parked on."""
        if self.park_factor is None or self.store is None:
            return
        for js in self._states:
            if js.done or not js.parked \
                    or js.job.space.name != space_name \
                    or js.job.kind != kind:
                continue
            model, _ = self.store.load_nearest_model(
                space_name, js.job.bucket, js.hw_key,
                bind_space=js.job.space, kind=kind)
            if model is None:
                continue
            js.predicted_best = float(np.min(
                predicted_runtimes(model, js.job.space, js.hw)))
            if js.account.best_runtime \
                    > self.park_factor * js.predicted_best:
                js.parked = False
                if self.verbose:
                    print(f"[fleet] {js.job.name}: unparked (new model "
                          f"predicts {js.predicted_best * 1e3:.3f}ms)")

    # -- completion ------------------------------------------------------------
    def _resolve_cancelled(self, js: _JobState) -> None:
        """Resolve a job to a partial, store-untouched ``cancelled`` result
        (explicit ``cancel_job`` or a graceful drain that caught it before
        it could run)."""
        acct = js.account
        js.done = True
        js.result = JobResult(
            job=js.job.name, bucket=js.job.bucket, hardware=js.hw_key,
            searcher=js.searcher_name, warm_started=js.warm_started,
            best_index=acct.best_index,
            best_config=dict(js.job.space[acct.best_index])
            if acct.best_index is not None else {},
            best_runtime=acct.best_runtime, trials=acct.steps,
            elapsed=acct.elapsed, busy=acct.busy,
            trace=list(acct.trace), history=list(acct.history),
            failures=js.failures, abandoned_s=acct.abandoned,
            known_bad=list(js.known_bad), parked=js.was_parked,
            cancelled=True,
            transfer_from=js.transfer_key,
            transfer_similarity=js.transfer_similarity,
            warm_from=js.warm_key)
        if self.verbose:
            print(f"[fleet] {js.job.name}: cancelled after "
                  f"{acct.steps} trials")
        if self.on_job_done is not None:
            self.on_job_done(js.result)

    def _finalize(self, js: _JobState) -> None:
        t0 = self.pool.elapsed()
        job, acct = js.job, js.account
        if acct.best_index is None and js.failures == 0 \
                and acct.steps == 0:
            if self._stopping:
                # graceful drain caught the job before its first test
                self._resolve_cancelled(js)
                return
            raise RuntimeError(f"job {job.name} made no empirical tests "
                               "(budget <= 0 or empty space?)")
        js.done = True
        js.result = JobResult(
            job=job.name, bucket=job.bucket, hardware=js.hw_key,
            searcher=js.searcher_name, warm_started=js.warm_started,
            best_index=acct.best_index,
            best_config=dict(job.space[acct.best_index])
            if acct.best_index is not None else {},
            best_runtime=acct.best_runtime, trials=acct.steps,
            elapsed=acct.elapsed, busy=acct.busy,
            trace=list(acct.trace), history=list(acct.history),
            failures=js.failures, abandoned_s=acct.abandoned,
            known_bad=list(js.known_bad), parked=js.was_parked,
            transfer_from=js.transfer_key,
            transfer_similarity=js.transfer_similarity,
            warm_from=js.warm_key)
        if self._stopping and not js.was_parked \
                and js.submitted < job.budget \
                and not (js.searcher is not None and js.searcher.done):
            # drained mid-search: partial result, flagged as such
            js.result.cancelled = True
        if self.store is None or acct.best_index is None:
            if self.on_job_done is not None:
                self.on_job_done(js.result)
            return
        # batch the entry + model artifact into ONE locked read-merge-write
        # (each autosave re-parses the whole file — at fleet scale two per
        # completion is measurable lock/IO churn on the event loop)
        was_autosave, self.store.autosave = self.store.autosave, False
        published = False
        train_fn = None
        try:
            self.store.put(
                job.space.name, job.bucket, js.hw_key,
                config=js.result.best_config, runtime=acct.best_runtime,
                trials=acct.steps,
                meta={"job": job.name, "searcher": js.searcher_name,
                      "warm_started": js.warm_started,
                      **({"transfer_from": js.transfer_key,
                          "transfer_similarity": js.transfer_similarity}
                         if js.transfer_key is not None else {})},
                kind=job.kind)
            if self.publish_models and self.store.get_model_dict(
                    job.space.name, job.bucket, js.hw_key,
                    kind=job.kind) is None:
                # train the portable TP→PC_ops model this job was missing
                # and publish it — the next (input, hardware) arrival
                # warm-starts from it
                from repro_torch.tuning.session import TuningSession

                space, wl, hw = job.space, job.workload_fn, js.hw
                seed, mk = job.seed, self.model_kind

                def train_fn():
                    session = TuningSession(space, wl, hw=hw, seed=seed)
                    session.train(kind=mk, sample="deliberate")
                    return session

                if self._trainer is None:
                    # synchronous fallback: train + publish inline
                    session = train_fn()
                    session.save_model_to_store(self.store, job.bucket,
                                                js.hw_key, kind=job.kind)
                    published = True
                    train_fn = None
        finally:
            self.store.autosave = was_autosave
        if was_autosave and self.store.path is not None:
            self.store.save()
        if published:
            self._unpark_check(job.space.name, kind=job.kind)
        if train_fn is not None:
            # off-loop: the fleet keeps dispatching while the model
            # trains; same-space jobs defer binding until it publishes
            pk = (job.space.name, job.kind)
            self._publish_keys[pk] = self._publish_keys.get(pk, 0) + 1
            self._trainer.submit("train", js, train_fn)
        self._absorb_stall(t0)
        if self.verbose:
            print(f"[fleet] {job.name}: best {acct.best_runtime*1e3:.3f}ms "
                  f"in {acct.steps} trials "
                  f"({'warm' if js.warm_started else 'cold'})")
        if self.on_job_done is not None:
            self.on_job_done(js.result)

    def _apply_publish(self, js: _JobState, session, error) -> None:
        """Trainer completion for a publish training (loop thread): store
        the artifact and re-check parked jobs, exactly as the synchronous
        path did — or, on a training exception, record the failure
        against this job and move on (the tuned entry already landed;
        only the portable model is lost).  The daemon never dies to a
        training crash."""
        job = js.job
        pk = (job.space.name, job.kind)
        n = self._publish_keys.get(pk, 0)
        if n <= 1:
            self._publish_keys.pop(pk, None)
        else:
            self._publish_keys[pk] = n - 1
        if error is not None:
            self.train_errors.append((job.name, f"train: {error!r}"))
            if self.verbose:
                print(f"[fleet] {job.name}: model training failed "
                      f"({error!r}); publish skipped")
            return
        was_autosave, self.store.autosave = self.store.autosave, False
        try:
            session.save_model_to_store(self.store, job.bucket,
                                        js.hw_key, kind=job.kind)
        finally:
            self.store.autosave = was_autosave
        if was_autosave and self.store.path is not None:
            self.store.save()
        self._unpark_check(job.space.name, kind=job.kind)
