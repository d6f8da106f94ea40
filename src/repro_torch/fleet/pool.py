"""Worker pools: the fleet's asynchronous measurement substrate.

All pools speak the same submit/collect protocol as the async evaluator
layer, but at fleet scope — one pool serves empirical tests from MANY jobs,
so a job whose searcher is waiting on its current batch never idles a
worker that another job could use:

* ``VirtualWorkerPool``    — deterministic simulated concurrency: work is
  evaluated eagerly (the cost-model workloads are pure) and completion
  times are scheduled on a virtual clock with ``workers`` parallel lanes.
  The benchmark/test backend: bit-reproducible, no threads — including its
  FAULT-INJECTION hooks (seeded random test failures, lane kills at a
  virtual time, cost-scaled stragglers), so every retry/timeout/park
  policy in the orchestrator is deterministically testable.
* ``ThreadWorkerPool``     — real in-process concurrency over a
  ``ThreadPoolExecutor``; costs and completion times are measured
  wall-clock.  For measurement callables that genuinely block (timed
  kernels, RPCs to devices).
* ``SubprocessWorkerPool`` — one persistent worker *process* per lane,
  speaking JSON-lines over stdin/stdout (``repro_torch.fleet.worker_main``).
  With ``devices=`` each lane owns one card and MEASURES there (a lane a
  card: two lanes timing on one card would interleave their timed
  windows); without, lanes price on the cost model.  Work items must carry
  a serializable ``payload`` (registry kernel + input + hardware + config
  index) instead of a closure.

Failure contract: a failed empirical test is DATA, not an exception.
``collect()`` never raises on a lane failure — it returns a
``FailedResult`` carrying the error text, an ``kind`` classifying it
(``"test"``: the measurement itself failed — crashing/invalid config;
``"lane"``: the worker died with the test in flight; ``"pool"``: no lane
was available to run it at all), the lane it ran on, and which ``attempt``
this was — so the orchestrator can retry on another lane
(``WorkItem.exclude``), give up after a budget, or mark the config
known-bad, instead of the whole fleet dying on its first crashed config.

``WorkItem.fn`` is a zero-arg callable returning ``(runtime, counters,
cost)`` — the same triple as ``Evaluator._evaluate`` — used by the
in-process pools; ``WorkItem.payload`` is the serializable description used
by subprocess pools.  ``WorkResult.finished_at`` is on the pool's clock
(virtual seconds or wall seconds since pool start).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.counters import CounterSet

EvalFn = Callable[[], Tuple[float, Optional[CounterSet], float]]

# Failure kinds carried by FailedResult.kind
FAIL_TEST = "test"   # the measurement itself errored (crashing config)
FAIL_LANE = "lane"   # the worker lane died with the test in flight
FAIL_POOL = "pool"   # no lane was available to run the test at all


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One empirical test, addressed back to its job by name.

    ``attempt`` counts resubmissions of the same logical test (0 = first
    try) and is echoed on the result; ``exclude`` names lanes the pool
    should avoid (the orchestrator's exclude-and-resubmit retry: don't
    hand a retry back to the lane that just failed it) — advisory: if
    every non-excluded lane is dead, any live lane is used.
    """

    uid: int
    job: str
    index: int
    profile: bool = False
    fn: Optional[EvalFn] = None
    payload: Optional[Dict[str, Any]] = None
    attempt: int = 0
    exclude: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class WorkResult:
    uid: int
    job: str
    index: int
    runtime: float
    counters: Optional[CounterSet]
    cost: float          # worker-seconds this test occupied a lane
    finished_at: float   # completion time on the pool clock
    error: Optional[str] = None
    kind: Optional[str] = None   # FAIL_TEST / FAIL_LANE / FAIL_POOL
    lane: int = -1               # lane the test ran on (-1: unknown)
    attempt: int = 0             # echoed from the WorkItem


@dataclasses.dataclass(frozen=True)
class FailedResult(WorkResult):
    """A failed empirical test surfaced as data instead of an exception.

    ``error`` is the human-readable cause, ``kind`` classifies it
    (``"test"`` / ``"lane"`` / ``"pool"``), ``lane`` is where it ran and
    ``attempt`` which retry this was.  ``runtime`` is ``inf`` and
    ``counters`` is ``None``; ``cost`` is the worker-seconds the failed
    attempt still burned (honest accounting feeds it to
    ``EvalAccount.record_abandoned``).
    """


def _failed(item: WorkItem, error: str, kind: str, lane: int, cost: float,
            finished_at: float) -> FailedResult:
    return FailedResult(
        uid=item.uid, job=item.job, index=item.index, runtime=float("inf"),
        counters=None, cost=cost, finished_at=finished_at, error=error,
        kind=kind, lane=lane, attempt=item.attempt)


def _run_here(item: WorkItem, t0: float) -> WorkResult:
    """``item.fn`` run in this process, charged the wall-clock seconds it
    took; a raising ``fn`` comes back as a failed test."""
    start = time.perf_counter()
    try:
        rt, cs, _ = item.fn()
        err = None
    except Exception as e:                      # surfaced at collect()
        rt, cs, err = float("inf"), None, f"{type(e).__name__}: {e}"
    end = time.perf_counter()
    return WorkResult(
        uid=item.uid, job=item.job, index=item.index, runtime=rt,
        counters=cs, cost=end - start, finished_at=end - t0,
        error=err, kind=FAIL_TEST if err is not None else None,
        attempt=item.attempt)


class VirtualWorkerPool:
    """Deterministic ``workers``-lane scheduling on a virtual clock.

    ``submit`` evaluates the item's pure ``fn`` immediately, assigns the
    test to the earliest-free lane (started no earlier than the last
    collection — the moment the orchestrator could have decided to submit),
    and schedules its completion; ``collect`` pops the earliest-finishing
    outstanding test and advances the clock to it.  ``elapsed()`` is the
    makespan so far — the fleet's simulated wall-clock.

    Fault injection (all deterministic, for tests/benchmarks):

    * ``fail_rate`` / ``fail_seed`` — each submitted attempt fails with
      this probability (kind ``"test"``), drawn from a dedicated seeded
      rng in submission order; the failed attempt still burns its cost.
    * ``fail_fn`` — ``fn(item) -> Optional[str]``: targeted injection —
      return an error string to fail exactly that attempt (kind
      ``"test"``; e.g. fail config 7 on its first attempt only).
    * ``kill_lane_at`` — ``{lane: virtual_time}``: the lane dies at that
      time.  A test in flight on it fails at the kill time (kind
      ``"lane"``, cost = the lane-seconds burned before the kill); the
      lane takes no further work.
    * ``cost_scale`` — ``fn(item) -> factor`` multiplying the item's cost
      (straggler injection: make one uid run 50x long).
    """

    def __init__(self, workers: int = 4, fail_rate: float = 0.0,
                 fail_seed: int = 0,
                 fail_fn: Optional[Callable[[WorkItem],
                                            Optional[str]]] = None,
                 kill_lane_at: Optional[Dict[int, float]] = None,
                 cost_scale: Optional[Callable[[WorkItem], float]] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = int(workers)
        self._free = [0.0] * self.workers
        self._now = 0.0
        self._heap: List[Tuple[float, int, WorkResult]] = []
        self._seq = 0
        self.fail_rate = float(fail_rate)
        self._fail_rng = np.random.default_rng(fail_seed)
        self._fail_fn = fail_fn
        self._kill = dict(kill_lane_at or {})
        self._cost_scale = cost_scale

    def _lane_dead_at(self, lane: int, t: float) -> bool:
        k = self._kill.get(lane)
        return k is not None and t >= k

    def _push(self, finish: float, res: WorkResult) -> None:
        heapq.heappush(self._heap, (finish, self._seq, res))
        self._seq += 1

    def submit(self, item: WorkItem) -> None:
        # choose the earliest-free lane among the alive ones, honouring the
        # item's exclusion list when any other alive lane exists
        alive = [i for i in range(self.workers)
                 if not self._lane_dead_at(i, max(self._now, self._free[i]))]
        if not alive:
            self._push(self._now, _failed(
                item, "all virtual lanes are dead", FAIL_POOL, -1, 0.0,
                self._now))
            return
        preferred = [i for i in alive if i not in item.exclude] or alive
        lane = min(preferred, key=lambda i: self._free[i])
        start = max(self._now, self._free[lane])
        rt, cs, cost = item.fn()
        if self._cost_scale is not None:
            cost *= float(self._cost_scale(item))
        kill = self._kill.get(lane)
        if kill is not None and start + cost > kill:
            # the lane dies mid-test: the attempt burned (kill - start)
            # lane-seconds and its result is lost
            self._free[lane] = kill
            self._push(kill, _failed(
                item, f"virtual lane {lane} killed at t={kill:.6f} with "
                "this test in flight", FAIL_LANE, lane,
                max(0.0, kill - start), kill))
            return
        finish = start + cost
        self._free[lane] = finish
        err = self._fail_fn(item) if self._fail_fn is not None else None
        if err is None and self.fail_rate > 0.0 \
                and self._fail_rng.random() < self.fail_rate:
            err = "injected test failure"
        if err is not None:
            self._push(finish, _failed(item, err, FAIL_TEST, lane, cost,
                                       finish))
            return
        self._push(finish, WorkResult(
            uid=item.uid, job=item.job, index=item.index, runtime=rt,
            counters=cs, cost=cost, finished_at=finish, lane=lane,
            attempt=item.attempt))

    def collect(self, timeout: Optional[float] = None) -> WorkResult:
        if not self._heap:
            raise RuntimeError("collect() with no outstanding work")
        finish, _, res = heapq.heappop(self._heap)
        self._now = max(self._now, finish)
        return res

    def outstanding(self) -> int:
        return len(self._heap)

    def alive_workers(self) -> int:
        """Lanes currently able to take new work."""
        return sum(1 for i in range(self.workers)
                   if not self._lane_dead_at(
                       i, max(self._now, self._free[i])))

    def elapsed(self) -> float:
        return self._now

    def close(self) -> None:
        pass


class ThreadWorkerPool:
    """Real in-process concurrency: ``workers`` threads, wall-clock costs.

    Suited to measurement callables that release the GIL or block (device
    RPCs, subprocess compiles, sleeps); a pure-Python compute-bound ``fn``
    will serialize on the GIL and show no speedup.  Threads are not
    addressable lanes, so ``WorkItem.exclude`` is a no-op here; a raising
    ``fn`` comes back as a ``FailedResult`` (kind ``"test"``).
    ``devices`` names the cards the jobs' evaluators measure on (the
    threads run whatever ``fn`` they are given; the tuning service reads
    the list to place measured jobs); None: nothing is declared.
    """

    def __init__(self, workers: int = 4,
                 devices: Optional[List[str]] = None):
        from concurrent.futures import ThreadPoolExecutor

        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if devices is not None and not devices:
            raise ValueError("devices= names no card")
        self.devices = list(devices) if devices is not None else None
        self.workers = int(workers)
        self._ex = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="fleet-worker")
        self._t0 = time.perf_counter()
        self._done: "queue.Queue[WorkResult]" = queue.Queue()
        self._outstanding = 0

    def _run(self, item: WorkItem) -> None:
        self._done.put(_run_here(item, self._t0))

    def submit(self, item: WorkItem) -> None:
        self._outstanding += 1
        self._ex.submit(self._run, item)

    def collect(self, timeout: Optional[float] = None) -> WorkResult:
        res = self._done.get(timeout=timeout)
        self._outstanding -= 1
        return res

    def outstanding(self) -> int:
        return self._outstanding

    def alive_workers(self) -> int:
        return self.workers

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def close(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)


class SubprocessWorkerPool:
    """Persistent evaluation processes over JSON-lines pipes, one a lane.

    Each lane runs ``python -m repro_torch.fleet.worker_main`` with its own
    interpreter.  With ``devices`` (e.g. ``["cuda:0", "cuda:1"]``) there is
    one lane a card, started with ``--device``: it builds and launches the
    registry kernels on that card and times them, and refuses any request
    it would have to price instead.  A pool that measures refuses more
    lanes than it has cards (``workers`` must equal ``len(devices)``, each
    card named once).  Without ``devices``, ``workers`` lanes price each
    test on the cost model.  Work items must carry a ``payload`` naming a
    registered kernel workload, except those of a job that names no kernel
    (a serve problem, priced on the cost model): these run in this
    process, charged the seconds they take here, and never reach a lane.
    Results stream back on a reader thread per
    lane, so ``collect`` sees completions in real finish order across the
    whole pool.  ``lane_info()`` reports each lane's device, the card's
    name and the launches of each kernel wrapper its tests made.

    Failure handling: a worker process that exits mid-run fails its
    in-flight tests with ``FailedResult``\\ s (kind ``"lane"``) — but only
    AFTER its reader thread has drained every completed result still
    buffered in the pipe, so a lane that wrote a result and then died never
    loses it.  ``submit`` with no live lanes enqueues a ``"pool"``-kind
    failure for the item (behind any already-buffered completions in the
    FIFO) instead of raising, so the orchestrator drains survivors before
    seeing the fleet-dead condition.
    """

    def __init__(self, workers: Optional[int] = None,
                 devices: Optional[List[str]] = None,
                 startup_timeout: float = 120.0):
        lanes = _lane_devices(workers, devices)
        self.workers = len(lanes)
        self.devices = lanes
        self._t0 = time.perf_counter()
        self._done: "queue.Queue[WorkResult]" = queue.Queue()
        self._outstanding = 0
        self._items: Dict[int, WorkItem] = {}
        self._owner: Dict[int, int] = {}   # uid -> worker lane
        self._lock = threading.Lock()
        self._procs: List[subprocess.Popen] = []
        self._busy = [0] * self.workers    # in-flight per worker (least-loaded)
        self._dead = [False] * self.workers
        self._readers: List[threading.Thread] = []
        # per lane: the card's name (from the handshake) and the launch
        # count of each kernel wrapper, as its last reply reported it
        self._lane_name: List[Optional[str]] = [None] * self.workers
        self._lane_launches: List[Dict[str, int]] = [
            {} for _ in range(self.workers)]

        import repro_torch

        src_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        for w, device in enumerate(lanes):
            cmd = [sys.executable, "-m", "repro_torch.fleet.worker_main"]
            if device is not None:
                cmd += ["--device", device]
            p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, env=env, text=True,
                                 bufsize=1)
            self._procs.append(p)
            t = threading.Thread(target=self._reader, args=(w, p),
                                 daemon=True)
            t.start()
            self._readers.append(t)
        # handshake: a ping per worker proves imports/devices came up
        try:
            for p in self._procs:
                p.stdin.write(json.dumps({"op": "ping"}) + "\n")
                p.stdin.flush()
            deadline = time.perf_counter() + startup_timeout
            for _ in range(self.workers):
                remaining = max(0.1, deadline - time.perf_counter())
                try:
                    res = self._done.get(timeout=remaining)
                except queue.Empty:
                    raise RuntimeError(
                        f"fleet worker produced no handshake within "
                        f"{startup_timeout:.0f}s (its stderr goes to this "
                        "process's stderr — check for import/device "
                        "errors)") from None
                if res.error is not None:
                    raise RuntimeError(f"fleet worker failed to start: "
                                       f"{res.error}")
        except BaseException:
            self.close()           # don't leak the surviving workers
            raise

    def lane_info(self) -> List[Dict[str, Any]]:
        """Each lane's device (None: priced), the name of its card as the
        lane reported it, and its kernel wrappers' launch counts."""
        with self._lock:
            return [{"lane": w, "device": self.devices[w],
                     "device_name": self._lane_name[w],
                     "launches": dict(self._lane_launches[w]),
                     "alive": not self._dead[w]}
                    for w in range(self.workers)]

    def _reader(self, worker: int, p: subprocess.Popen) -> None:
        for line in p.stdout:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if msg.get("op") == "pong":
                with self._lock:
                    self._lane_name[worker] = msg.get("device_name")
                self._done.put(WorkResult(uid=-1, job="", index=-1,
                                          runtime=0.0, counters=None,
                                          cost=0.0, finished_at=0.0,
                                          error=msg.get("error")))
                continue
            with self._lock:
                item = self._items.pop(msg["uid"], None)
                self._owner.pop(msg["uid"], None)
                self._busy[worker] -= 1
                if "launches" in msg:
                    self._lane_launches[worker].update(msg["launches"])
            if item is None:
                continue
            if msg.get("error") is not None:
                self._done.put(_failed(
                    item, msg["error"], FAIL_TEST, worker,
                    float(msg.get("cost", 0.0)),
                    time.perf_counter() - self._t0))
                continue
            cs = None
            if "ops" in msg:
                cs = CounterSet(ops=msg["ops"], stress=msg["stress"],
                                runtime=float(msg["runtime"]))
            self._done.put(WorkResult(
                uid=item.uid, job=item.job, index=item.index,
                runtime=float(msg.get("runtime", float("inf"))),
                counters=cs, cost=float(msg.get("cost", 0.0)),
                finished_at=time.perf_counter() - self._t0,
                lane=worker, attempt=item.attempt))
        # stdout EOF: the worker exited.  Everything it had written before
        # dying was already drained by the loop above (the pipe stays
        # readable to EOF after process death), so no completed result is
        # lost; only the genuinely in-flight items fail — as data, kind
        # "lane", so the orchestrator can resubmit them elsewhere.
        with self._lock:
            self._dead[worker] = True
            lost = [uid for uid, w in self._owner.items() if w == worker]
            items = [self._items.pop(uid) for uid in lost]
            for uid in lost:
                del self._owner[uid]
            self._busy[worker] = 0
        now = time.perf_counter() - self._t0
        for item in items:
            self._done.put(_failed(
                item, f"worker process {worker} exited (rc={p.poll()}) "
                "with this test in flight", FAIL_LANE, worker, 0.0, now))

    def submit(self, item: WorkItem) -> None:
        if item.payload is None:
            if item.fn is None:
                raise ValueError(
                    "SubprocessWorkerPool needs serializable payloads "
                    "(build jobs with fleet.job_from_registry)")
            # a job that names no kernel (a serve problem, priced on the
            # cost model) runs in this process, never in a lane
            self._outstanding += 1
            self._done.put(_run_here(item, self._t0))
            return
        self._outstanding += 1
        while True:
            with self._lock:
                alive = [i for i in range(self.workers) if not self._dead[i]]
                if not alive:
                    # fleet-dead is a per-item failure, queued BEHIND any
                    # results the reader threads already drained — the
                    # caller sees every completed test before the death
                    self._done.put(_failed(
                        item, "all fleet worker processes have died",
                        FAIL_POOL, -1, 0.0,
                        time.perf_counter() - self._t0))
                    return
                preferred = [i for i in alive if i not in item.exclude] \
                    or alive
                worker = min(preferred, key=lambda i: self._busy[i])
                self._busy[worker] += 1
                self._items[item.uid] = item
                self._owner[item.uid] = worker
            req = dict(item.payload)
            req.update(uid=item.uid, index=int(item.index),
                       profile=bool(item.profile), attempt=int(item.attempt))
            p = self._procs[worker]
            try:
                p.stdin.write(json.dumps(req) + "\n")
                p.stdin.flush()
                return
            except (BrokenPipeError, OSError):
                # the lane died between the reader noticing and us writing:
                # un-book the item and try the next live lane — UNLESS the
                # reader's EOF handler already claimed it (it saw our
                # booking and enqueued a lane-kind failure); resubmitting
                # then would produce a second result for the same uid and
                # drive the outstanding count negative
                with self._lock:
                    self._dead[worker] = True
                    if self._items.pop(item.uid, None) is None:
                        return
                    self._owner.pop(item.uid, None)

    def collect(self, timeout: Optional[float] = None) -> WorkResult:
        res = self._done.get(timeout=timeout)
        self._outstanding -= 1
        return res

    def outstanding(self) -> int:
        return self._outstanding

    def alive_workers(self) -> int:
        with self._lock:
            return sum(1 for d in self._dead if not d)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def close(self) -> None:
        """Shut every lane down and wait for it (killed after 10 s)."""
        for p in self._procs:
            try:
                if p.stdin and not p.stdin.closed:
                    p.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
                    p.stdin.flush()
                    p.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def _lane_devices(workers: Optional[int],
                  devices: Optional[List[str]]) -> List[Optional[str]]:
    """One entry a lane: its device, or None for a lane that prices.  A
    measuring pool has one lane a card: ``workers`` (when given) must equal
    the cards, each card named once, each one visible."""
    if devices is None:
        workers = 2 if workers is None else int(workers)
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        return [None] * workers
    if not devices:
        raise ValueError("devices= names no card")
    import torch

    lanes = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            index = 0 if dev.index is None else dev.index
            visible = torch.cuda.device_count()
            if index >= visible:
                raise ValueError(f"{d}: only {visible} CUDA cards are "
                                 "visible")
            lanes.append(f"cuda:{index}")
        elif dev.type == "cpu":
            lanes.append("cpu")
        else:
            raise ValueError(f"a lane measures on a CUDA card or the CPU, "
                             f"not {d!r}")
    if len(set(lanes)) != len(lanes):
        raise ValueError(f"one lane a card: {devices} names a card twice "
                         "(two lanes timing on one card interleave their "
                         "timed windows)")
    if workers is not None and int(workers) != len(lanes):
        raise ValueError(f"a measuring pool has one lane a card: workers="
                         f"{workers} for {len(lanes)} devices")
    return lanes
