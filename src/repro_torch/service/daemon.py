"""``TuningDaemon`` — the tuning-as-a-service process.

One long-lived daemon owns one worker pool, one elastic ``FleetTuner``
(started empty, jobs injected while it runs), and one shared config/model
corpus (usually a ``ShardedConfigStore``).  Tenants connect over a
localhost TCP socket and speak the JSON-lines protocol; every accepted
``submit`` becomes a ``TuningJob`` named after its request id, and the
fleet's gain-priority scheduler multiplexes all tenants' trials onto the
pool.  Three things make it a *service* rather than a batch fleet:

* **store-first answering** — a submit whose ``(space, bucket, hardware)``
  key is already in the corpus resolves immediately with ZERO trials;
  identical requests in flight are *coalesced* (followers ride the
  primary's tuning run and also pay zero);
* **tenant policy** — admission caps and per-tenant worker-seconds
  budgets, metered every loop tick from the fleet's own ``EvalAccount``
  ledgers (abandoned/retried attempts included); an exhausted tenant's
  queued work is parked and new submits rejected, without touching
  anyone else's jobs;
* **graceful drain** — ``shutdown`` (or SIGTERM via the CLI) stops
  admissions, lets in-flight empirical tests finish, resolves unfinished
  jobs as ``cancelled`` partials, and flushes the store.

Threading model: reader threads (one per connection) only touch daemon
state under ``self._lock``; the single loop thread holds the same lock
across ``admit → fleet.step → meter``, so fleet internals are never
entered concurrently.  ``step`` bounds its wait (``max_wait``) to keep
submit latency low while the pool is busy, and after each tick the loop
lets in the request ops that were waiting for the lock before it takes
the lock again: a pool that measures on a card makes progress at every
step, and a lock retaken at once would keep a ``status`` waiting for a
whole job.

Crash safety: with a ``journal`` configured, every request state
transition (and every tenant budget charge) is appended to a
write-ahead ``RequestJournal`` BEFORE the acknowledging response is
sent.  A daemon restarted over the same journal with ``recover=True``
replays it: requests that finished are answered from the store,
interrupted ones are resubmitted with only their REMAINING trial
budget (progress checkpoints journal per completed trial), tenant
spend is restored so budgets survive the restart, and journaled
results missing from the store (e.g. a quarantined shard) are re-put.
Submits carrying an ``idempotency_key`` dedupe onto the original
request across retries and restarts.

Measured or priced.  This is the JAX package's daemon over the port's
fleet.  The daemon learns its cards from one place, the pool's
``devices``: a ``SubprocessWorkerPool(devices=[...])`` or a
``ThreadWorkerPool(devices=[...])`` MEASURES.  Each kernel request is then
a job measured on a card whose spec has the request's
``hwspec.hardware_key`` (the jobs of one hardware key go to its cards in
turn), and a request for hardware the daemon has no card of is refused at
``submit``, before any test; no test is ever priced in place of a
measurement.  A subprocess lane's card is known by the name the lane
reports, so the daemon process itself never touches CUDA.  The CPU
(``"cpu"``, the kernels' plain versions, for tests) stands in for a
``CPU_HARDWARE`` card.  A pool without devices (``VirtualWorkerPool``, or
subprocess lanes without devices) PRICES each test on the cost model,
exactly as the JAX daemon does.

Serve and sharding requests are priced, by a measuring daemon too.  A
``sharding:`` problem becomes a job of the ``ShardingProblem`` the JAX
daemon builds, its tests priced on the cost model for the named hardware.
A serve-kind submit (and a ``serve:`` problem) becomes a job of the
``ServeProblem`` the JAX daemon builds: its tests price the portable
serving workload on the cost model for the named hardware (a registered
spec, or the spec the client ships), as the JAX daemon prices them, and no
serving engine is measured in a lane (a ``SubprocessWorkerPool`` prices
such a test in the daemon's own process).  Their store keys
(``serve|<space>|<bucket>|<hardware>``) lie in a namespace of their own,
so a priced serve entry in a measuring daemon's corpus never answers a
kernel request, and it means the same in a corpus of any provenance.

Priced, CPU-measured and card-measured results share store keys, so they
never share a store or a journal: a measuring daemon stamps its store
(``set_provenance``) and its ``daemon_start`` records with
``PROVENANCE_CPU`` or ``PROVENANCE_CARD``, and every daemon refuses a store
or journal of another provenance.  A priced daemon stamps nothing, as the
JAX daemon does, so an unstamped store that holds results reads as priced
and a measuring daemon refuses it too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core import hwspec
from repro_torch.core.account import AccountSnapshot
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.fleet import FleetTuner, JobResult, TuningJob
from repro_torch.service import health as H
from repro_torch.service import protocol as P
from repro_torch.service.journal import (EV_CANCELLED, EV_CHARGE,
                                         EV_DAEMON_START, EV_DONE,
                                         EV_PROGRESS, EV_START, EV_SUBMIT,
                                         RequestJournal, replay)
from repro_torch.service.tenants import AdmissionError, TenantManager
from repro_torch.tuning.store import split_key, store_key

# the card a "cpu" device of a measuring pool stands in for (tests measure
# the kernels' plain versions there)
CPU_HARDWARE = "h100_sxm"

# how a daemon's results are obtained (its store's and journal's stamp)
PROVENANCE_PRICED = "priced"
PROVENANCE_CPU = "cpu"
PROVENANCE_CARD = "card"
_OBTAINED = {PROVENANCE_PRICED: "priced on the cost model",
             PROVENANCE_CPU: "measured on the CPU (the plain versions)",
             PROVENANCE_CARD: "measured on CUDA cards"}

# the longest the fleet loop waits, after a tick, for the request ops that
# were waiting for the daemon lock to take it
STEP_ASIDE_S = 1.0

# request states (the wire-visible lifecycle)
QUEUED = "queued"
PARKED = "parked"        # queued, but its tenant's budget is exhausted
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"


@dataclasses.dataclass
class RequestRecord:
    """One accepted submit, from socket to resolution."""

    rid: str
    tenant: str
    kind: str                     # "kernel" | "serve" | "problem"
    key: str                      # kind|space|bucket|hardware store key
    state: str = QUEUED
    job: Optional[TuningJob] = None
    snap: Optional[AccountSnapshot] = None   # metering baseline
    spent_s: float = 0.0          # worker-seconds billed to this request
    trials: int = 0               # live trials this request paid for
    source: Optional[str] = None  # "store" | "tuned" | "transfer"
    #                               | "coalesced"
    primary: Optional[str] = None  # rid this request coalesced onto
    followers: List[str] = dataclasses.field(default_factory=list)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    idem: Optional[str] = None    # client-supplied idempotency key
    recovered: bool = False       # restored/resubmitted by journal replay
    resumed_trials: int = 0       # trials checkpointed before the crash

    def status_dict(self) -> Dict[str, Any]:
        return {
            "request_id": self.rid, "tenant": self.tenant,
            "kind": self.kind, "key": self.key, "state": self.state,
            "trials": self.trials, "spent_s": round(self.spent_s, 6),
            "source": self.source, "primary": self.primary,
            "error": self.error, "recovered": self.recovered,
        }


def _pool_cards(pool) -> List[Tuple[str, HardwareSpec]]:
    """``(device, spec)`` of every card the pool measures on, read off its
    ``devices`` (None entries are priced lanes).  A CUDA card's spec is read
    off the card name its lane reported (``lane_info``), so this process
    opens no CUDA context beside the lane timing on that card; a pool
    without lanes measures in this process, which detects its cards.  The
    CPU's spec is ``CPU_HARDWARE``'s."""
    cards = []
    names = None
    for lane, device in enumerate(getattr(pool, "devices", None) or ()):
        if device is None:
            continue
        if device == "cpu":
            spec = hwspec.get(CPU_HARDWARE)
        elif hasattr(pool, "lane_info"):
            if names is None:
                names = [info["device_name"] for info in pool.lane_info()]
            spec = hwspec.spec_for_device_name(names[lane])
        else:
            import torch

            index = torch.device(device).index
            spec = hwspec.detect(0 if index is None else index)
        cards.append((device, spec))
    return cards


def _provenance(cards: List[Tuple[str, HardwareSpec]]) -> str:
    """How a daemon on ``cards`` obtains its results."""
    kinds = {PROVENANCE_CPU if device == "cpu" else PROVENANCE_CARD
             for device, _ in cards}
    if len(kinds) > 1:
        raise ValueError(
            "a daemon measures on CUDA cards or on the CPU, not on both: "
            "the CPU's results would stand in for a card's under its keys")
    return kinds.pop() if kinds else PROVENANCE_PRICED


def _claim_store(store, provenance: str) -> None:
    """Hold ``store`` to ``provenance``, stamping it when a measuring
    daemon finds it unstamped and empty.  A priced store stays unstamped."""
    have = getattr(store, "provenance", None)
    if have == (None if provenance == PROVENANCE_PRICED else provenance):
        return
    where = getattr(store, "path", None) or "the store"
    mine = _OBTAINED[provenance]
    if have is not None:
        raise ValueError(
            f"{where} holds results {_OBTAINED.get(have, have)}; a daemon "
            f"whose results are {mine} would answer from them: give it a "
            "store of its own")
    if len(store) or next(iter(store.model_keys()), None) is not None:
        raise ValueError(
            f"{where} holds unstamped results: priced on the cost model "
            "(a priced daemon stamps nothing) or written outside the "
            f"daemon; a daemon whose results are {mine} would answer from "
            "them: give it a store of its own")
    store.set_provenance(provenance)


def _check_journal(path: str, provenance: str) -> None:
    """Refuse a journal that a daemon of another provenance wrote: its
    results would be re-put and its requests resumed as this daemon's."""
    for ev in replay(path)[0]:
        if ev.get("ev") != EV_DAEMON_START:
            continue
        have = ev.get("provenance", PROVENANCE_PRICED)
        if have != provenance:
            raise ValueError(
                f"journal {path} was written by a daemon whose results are "
                f"{_OBTAINED.get(have, have)}, not "
                f"{_OBTAINED[provenance]}: give this daemon a journal of "
                "its own")


class _ConnState:
    """One client connection's buffers inside the daemon's IO loop.

    ``out`` holds ``(gate_seq, encoded_response)`` pairs in request
    order: a response may only be sent once the journal's durable
    watermark reaches its gate (0 = no durability dependency), so
    per-connection FIFO ordering and the write-ahead guarantee hold at
    the same time.
    """

    __slots__ = ("sock", "rbuf", "out", "wbuf", "closing", "interest")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = b""
        self.out: deque = deque()
        self.wbuf = b""
        self.closing = False
        self.interest = selectors.EVENT_READ


class TuningDaemon:
    """Multi-tenant tuning service over one fleet and one store.

    ``port=0`` binds an ephemeral localhost port (read it back from
    ``daemon.port`` after ``start()``).  ``default_trial_budget`` caps
    jobs whose submit named no budget; ``gc_keep`` (a dict of ``prune``
    keep-filters) enables periodic store GC every ``gc_every_s`` of
    wall time, with the last stats kept in ``gc_stats``.
    """

    def __init__(self, pool, store,
                 host: str = "127.0.0.1", port: int = 0,
                 tenants: Optional[TenantManager] = None,
                 default_trial_budget: int = 16,
                 max_active_jobs: int = 32,
                 step_wait: float = 0.05,
                 gc_keep: Optional[Dict[str, Any]] = None,
                 gc_every_s: float = 60.0,
                 journal: Optional[Union[str, RequestJournal]] = None,
                 recover: bool = False,
                 verbose: bool = False,
                 **fleet_kwargs):
        self.pool = pool
        self.store = store
        # (device, spec) of every card the pool measures on; empty: priced
        self.cards = _pool_cards(pool)
        self.provenance = _provenance(self.cards)
        _claim_store(store, self.provenance)
        if journal is not None:
            _check_journal(journal.path if isinstance(journal, RequestJournal)
                           else journal, self.provenance)
        self._turns: Dict[str, int] = {}    # hardware key -> jobs placed
        self.host = host
        self.port = port
        self.tenants = tenants if tenants is not None else TenantManager()
        self.default_trial_budget = int(default_trial_budget)
        self.max_active_jobs = int(max_active_jobs)
        self.step_wait = float(step_wait)
        self.gc_keep = gc_keep
        self.gc_every_s = float(gc_every_s)
        self.gc_stats: Optional[Dict[str, int]] = None
        self.verbose = verbose
        self.tuner = FleetTuner([], pool, store=store, allow_empty=True,
                                on_job_done=self._on_job_done,
                                on_trial=self._on_trial,
                                **fleet_kwargs)
        self.final_report = None
        self._lock = threading.RLock()
        # request ops that asked for the lock and that took it, ever: the
        # fleet loop lets the ones waiting in before its next tick
        self._asked = 0
        self._let_in = 0
        self._asked_lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._draining = False
        self._seq = 0
        self._records: Dict[str, RequestRecord] = {}
        self._pending: deque = deque()          # rids waiting for the fleet
        self._by_key: Dict[str, str] = {}       # active primary per key
        self._idem: Dict[Tuple[str, str], str] = {}   # (tenant, key) -> rid
        self._server: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._loop_thread: Optional[threading.Thread] = None
        self._heartbeat: Optional[float] = None
        self._last_gc = 0.0
        self.journal: Optional[RequestJournal] = None
        if isinstance(journal, RequestJournal):
            self.journal = journal
        elif journal is not None:
            self.journal = RequestJournal(journal)
        self.recovery: Optional[Dict[str, Any]] = None
        if recover:
            if self.journal is None:
                raise ValueError("recover=True requires a journal")
            self._recover()
        if self.journal is not None:
            # a priced daemon's record is the JAX daemon's
            stamp = {} if self.provenance == PROVENANCE_PRICED \
                else {"provenance": self.provenance}
            self.journal.append(EV_DAEMON_START, recovered=bool(recover),
                                **stamp)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Bind the socket, start the IO + fleet-loop threads."""
        self._server = socket.create_server((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        if self.journal is not None:
            self.journal.add_commit_listener(self._notify_io)
        self.tuner.begin()
        for fn, name in ((self._io_loop, "service-io"),
                         (self._fleet_loop, "service-fleet")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
            if name == "service-fleet":
                self._loop_thread = t
        if self.verbose:
            print(f"[service] listening on {self.host}:{self.port}")
        return self.host, self.port

    @property
    def address(self) -> Tuple[str, int]:
        return self.host, self.port

    def shutdown(self, drain: bool = True) -> None:
        """Stop accepting work and wind the fleet down.

        ``drain=True`` lets in-flight empirical tests finish (their
        results are collected and billed) before unfinished jobs resolve
        as ``cancelled`` partials; ``drain=False`` abandons in-flight
        work immediately (it is still billed when the lanes come back —
        the abandoned-cost policy).
        """
        with self._lock:
            if self._draining:
                return
            self._draining = True
            for rid in list(self._pending):
                self._resolve_cancelled_rid(rid, "daemon shutting down")
            self._pending.clear()
            if not drain:
                for rec in self._records.values():
                    if rec.state == RUNNING:
                        self.tuner.cancel_job(rec.rid)
            self.tuner.stop()
        self._wake.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the daemon has fully stopped."""
        return self._stopped.wait(timeout)

    def serve_forever(self) -> None:
        if self._server is None:
            self.start()
        self.wait()

    def __enter__(self) -> "TuningDaemon":
        if self._server is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)
        self.wait(timeout=60.0)

    # -- the fleet loop --------------------------------------------------------
    def _fleet_loop(self) -> None:
        while True:
            self._heartbeat = time.monotonic()
            with self._lock:
                if not self._draining:
                    self._admit_pending()
                    self._maybe_gc()
                progressed = self.tuner.step(max_wait=self.step_wait)
                self._meter()
                if self._draining and not progressed:
                    break
            # a lock released and retaken at once starves the request ops
            # queued on it: on a measuring pool every step makes progress,
            # so a status or submit would wait out a whole job.  Let the
            # ones waiting now take the lock first.
            with self._asked_lock:
                asked = self._asked
            deadline = time.monotonic() + STEP_ASIDE_S
            while self._let_in < asked and time.monotonic() < deadline:
                time.sleep(0.0005)
            if not progressed:
                self._wake.wait(0.2)
                self._wake.clear()
        with self._lock:
            self.final_report = self.tuner.finish()
            if getattr(self.store, "autosave", True) is False:
                self.store.save()
            if self.journal is not None:
                self.journal.sync()
        if self._server is not None:
            # close() alone does not wake a thread blocked in accept();
            # shutdown() forces it out with an error first
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        self._stopped.set()
        if self.verbose:
            print("[service] stopped")

    def _j(self, ev: str, **fields: Any) -> None:
        """Append one write-ahead journal record (no-op when disabled).

        Enqueues without waiting: ``handle`` waits for the journal tail
        to become durable AFTER releasing the request lock, so in
        ``batch`` mode one group commit covers every record the
        concurrent requests enqueued — the write-ahead guarantee (no
        ack before durability) is upheld at ~1 fsync per batch.
        """
        if self.journal is not None:
            self.journal.append(ev, wait=False, **fields)

    def _admit_pending(self) -> None:
        """Move queued requests into the fleet, least-spent tenant first."""
        active = sum(1 for r in self._records.values()
                     if r.state == RUNNING)
        if not self._pending or active >= self.max_active_jobs:
            return
        order = {n: i for i, n in enumerate(
            self.tenants.fairness_order(
                sorted({self._records[rid].tenant
                        for rid in self._pending})))}
        for rid in sorted(self._pending,
                          key=lambda r: (order[self._records[r].tenant], r)):
            if active >= self.max_active_jobs:
                break
            rec = self._records[rid]
            ts = self.tenants.get(rec.tenant)
            if ts is None:
                continue
            if ts.exhausted:
                if rec.state == QUEUED:
                    rec.state = PARKED
                    ts.parked += 1
                continue
            if rec.state == PARKED:      # budget topped back up: unpark
                rec.state = QUEUED
            if not self.tenants.can_start(ts):
                continue
            self._pending.remove(rid)
            self.tuner.add_job(rec.job)
            acct = self.tuner.job_account(rid)
            rec.snap = acct.snapshot() if acct is not None else None
            rec.state = RUNNING
            self._j(EV_START, rid=rid)
            ts.queued -= 1
            ts.active += 1
            active += 1
            if self.verbose:
                print(f"[service] {rid} -> fleet ({rec.key})")

    def _meter(self) -> None:
        """Bill each running request's worker-seconds since last tick."""
        for rec in self._records.values():
            if rec.state != RUNNING:
                continue
            acct = self.tuner.job_account(rec.rid)
            if acct is None or rec.snap is None:
                continue
            delta = acct.diff(rec.snap)
            if delta.busy > 0 or delta.steps > 0:
                ts = self.tenants.get(rec.tenant)
                if ts is not None:
                    self.tenants.charge(ts, delta.busy)
                if delta.busy > 0:
                    self._j(EV_CHARGE, tenant=rec.tenant, rid=rec.rid,
                            s=round(delta.busy, 9))
                rec.spent_s += delta.busy
                rec.snap = acct.snapshot()
                rec.trials = rec.snap.steps

    def _maybe_gc(self) -> None:
        if self.gc_keep is None:
            return
        now = self.pool.elapsed()
        if now - self._last_gc < self.gc_every_s:
            return
        self._last_gc = now
        self.gc_stats = self.store.prune(**self.gc_keep)
        if self.verbose and self.gc_stats.get("dropped"):
            print(f"[service] store GC: {self.gc_stats}")

    def _on_job_done(self, jr: JobResult) -> None:
        """Fleet callback (fires inside ``step`` under our lock)."""
        rec = self._records.get(jr.job)
        if rec is None:
            return
        self._meter_final(rec)
        ts = self.tenants.get(rec.tenant)
        if ts is not None and rec.state == RUNNING:
            ts.active -= 1
        self._by_key.pop(rec.key, None)
        if jr.cancelled or jr.best_index is None:
            rec.state = CANCELLED
            rec.error = "cancelled before completion" if jr.cancelled \
                else "every empirical test failed"
            self._j(EV_CANCELLED, rid=rec.rid, error=rec.error)
            for frid in rec.followers:
                self._resolve_cancelled_rid(
                    frid, f"primary {rec.rid} was cancelled")
        else:
            rec.state = DONE
            # a job warm-started from the cross-space transfer tier is
            # still live-tuned, but callers reading `source` learn the
            # prior came from ANOTHER space's model — with the source
            # key and similarity to judge it by
            rec.source = "transfer" if jr.transfer_from is not None \
                else "tuned"
            rec.trials = jr.trials + rec.resumed_trials
            rec.result = {
                "key": rec.key, "config": dict(jr.best_config),
                "runtime": jr.best_runtime, "trials": rec.trials,
                "searcher": jr.searcher, "warm_started": jr.warm_started,
                "source": rec.source,
            }
            if jr.transfer_from is not None:
                rec.result["transfer_from"] = jr.transfer_from
                rec.result["similarity"] = jr.transfer_similarity
            self._j(EV_DONE, rid=rec.rid, result=rec.result,
                    spent=round(rec.spent_s, 9))
            for frid in rec.followers:
                frec = self._records.get(frid)
                if frec is None or frec.state == CANCELLED:
                    continue
                fts = self.tenants.get(frec.tenant)
                if fts is not None:
                    fts.queued -= 1
                    fts.store_hits += 1
                frec.state = DONE
                frec.source = "coalesced"
                frec.result = dict(rec.result, source="coalesced",
                                   trials=0)
                self._j(EV_DONE, rid=frid, result=frec.result,
                        spent=round(frec.spent_s, 9))
        if self.verbose:
            print(f"[service] {rec.rid} {rec.state} "
                  f"(trials={rec.trials}, spent={rec.spent_s:.3f}s)")

    def _meter_final(self, rec: RequestRecord) -> None:
        acct = self.tuner.job_account(rec.rid)
        if acct is None or rec.snap is None:
            return
        delta = acct.diff(rec.snap)
        ts = self.tenants.get(rec.tenant)
        if ts is not None:
            self.tenants.charge(ts, delta.busy)
        if delta.busy > 0:
            self._j(EV_CHARGE, tenant=rec.tenant, rid=rec.rid,
                    s=round(delta.busy, 9))
        rec.spent_s += delta.busy
        rec.snap = acct.snapshot()
        rec.trials = rec.snap.steps

    def _on_trial(self, job_name: str, trials: int, best: float) -> None:
        """Fleet per-trial hook: journal a progress checkpoint so a
        crashed daemon resumes this request with its REMAINING budget
        (daemon jobs are named after their rid)."""
        rec = self._records.get(job_name)
        if rec is None:
            return
        self._j(EV_PROGRESS, rid=rec.rid,
                trials=int(trials) + rec.resumed_trials,
                best=(best if best != float("inf") else None))

    def _resolve_cancelled_rid(self, rid: str, why: str) -> None:
        rec = self._records.get(rid)
        if rec is None or rec.state in (DONE, CANCELLED):
            return
        if rec.state in (QUEUED, PARKED):
            ts = self.tenants.get(rec.tenant)
            if ts is not None:
                ts.queued -= 1
        rec.state = CANCELLED
        rec.error = why
        self._j(EV_CANCELLED, rid=rid, error=why)
        self._by_key.pop(rec.key, None)
        if rec.primary is not None:
            prec = self._records.get(rec.primary)
            if prec is not None and rid in prec.followers:
                prec.followers.remove(rid)

    # -- request handling ------------------------------------------------------
    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Dispatch one validated request (thread-safe; used directly by
        in-process tests and by the socket reader threads).

        Write-ahead discipline: ops run (and journal) under the request
        lock, but the durability wait happens AFTER the lock is
        released — concurrent requests each block only until the group
        commit covering their records lands, instead of serializing one
        fsync each inside the lock."""
        op = req["op"]
        with self._request_lock():
            resp = self._dispatch(op, req)
            ticket = self.journal.ticket() if self.journal is not None else 0
        if ticket:
            self.journal.wait_durable(ticket)
        return resp

    @contextlib.contextmanager
    def _request_lock(self):
        """The daemon lock, for a request op: counted when it asks and when
        it takes the lock, so that the fleet loop lets it in."""
        with self._asked_lock:
            self._asked += 1
        with self._lock:
            self._let_in += 1
            yield

    def _dispatch(self, op: str, req: Dict[str, Any]) -> Dict[str, Any]:
        if op == "ping":
            return P.ok(protocol=P.PROTOCOL, version=P.PROTOCOL_VERSION)
        if op == "submit":
            return self._op_submit(req)
        if op == "status":
            return self._op_status(req)
        if op == "result":
            return self._op_result(req)
        if op == "cancel":
            return self._op_cancel(req)
        if op == "stats":
            return self._op_stats()
        if op == "health":
            return self._op_health()
        if op == "shutdown":
            threading.Thread(target=self.shutdown,
                             kwargs={"drain": req["drain"]},
                             daemon=True).start()
            return P.ok(draining=True)
        return P.err(f"unhandled op {op!r}", code=P.E_INTERNAL)

    def _next_rid(self) -> str:
        self._seq += 1
        return f"r{self._seq:06d}"

    def _op_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        # idempotent resubmit: a key we have seen resolves to the
        # ORIGINAL request, whatever state it is in — checked before
        # draining/admission so a crash-retry is never double-charged
        # or bounced by queue caps its first attempt already passed
        idem = req.get("idempotency_key")
        if idem is not None:
            prev = self._idem.get((req["tenant"], idem))
            if prev is not None and prev in self._records:
                return self._dedupe_response(self._records[prev])
        if self._draining:
            return P.err("daemon is draining", code=P.E_DRAINING)
        try:
            ts = self.tenants.admit(req["tenant"],
                                    budget_s=req.get("tenant_budget_s"))
            self.tenants.check_submit(ts)
        except AdmissionError as exc:
            return P.err(str(exc), code=exc.code)
        try:
            job, key = self._build_job(req)
        except P.ProtocolError as exc:
            ts.rejected += 1
            return P.err(str(exc), code=exc.code)
        rid = self._next_rid()
        rec = RequestRecord(rid=rid, tenant=req["tenant"],
                            kind=req["kind"], key=key, job=job, idem=idem)
        self._records[rid] = rec
        if idem is not None:
            self._idem[(req["tenant"], idem)] = rid
        ts.submitted += 1
        # write-ahead: the accepted submit (with its full validated
        # payload — enough to rebuild the job after a crash) is durable
        # BEFORE the client sees the request id
        self._j(EV_SUBMIT, rid=rid, key=key, idem=idem, req=req)
        # store-first: a known key is answered with zero trials
        kind, space, bucket, hw = split_key(key)
        entry = self.store.get(space, bucket, hw, kind=kind)
        if entry is not None:
            rec.state = DONE
            rec.source = "store"
            rec.result = {"key": key, "config": dict(entry.config),
                          "runtime": entry.runtime,
                          "trials": 0, "entry_trials": entry.trials,
                          "source": "store"}
            ts.store_hits += 1
            self._j(EV_DONE, rid=rid, result=rec.result, spent=0.0)
            return P.ok(request_id=rid, state=DONE, **rec.result)
        # coalesce onto an identical request already in flight
        primary = self._by_key.get(key)
        if primary is not None:
            prec = self._records[primary]
            prec.followers.append(rid)
            rec.primary = primary
            rec.source = "coalesced"
            ts.queued += 1
            return P.ok(request_id=rid, state=QUEUED, coalesced=primary)
        job.name = rid
        self._by_key[key] = rid
        self._pending.append(rid)
        ts.queued += 1
        self._wake.set()
        return P.ok(request_id=rid, state=QUEUED)

    def _dedupe_response(self, rec: RequestRecord) -> Dict[str, Any]:
        """Answer a retried submit from the original request's state."""
        if rec.state == DONE and rec.result is not None:
            return P.ok(request_id=rec.rid, state=DONE, deduped=True,
                        **rec.result)
        return P.ok(request_id=rec.rid, state=rec.state, deduped=True)

    def _build_job(self, req: Dict[str, Any]) -> Tuple[TuningJob, str]:
        budget = req["budget"] if req["budget"] is not None \
            else self.default_trial_budget
        if req["kind"] == "problem":
            from repro_torch.fleet import job_from_problem
            from repro_torch.tuning.problem import parse_problem
            try:
                problem = parse_problem(req["problem"], **req["params"])
            except (KeyError, ValueError, TypeError) as exc:
                raise P.ProtocolError(str(exc), code=P.E_UNKNOWN_PROBLEM) \
                    from None
            # a problem that names no kernel (sharding, serve) is priced,
            # never placed on a card
            hardware, device = self._place(req["hardware"]) \
                if problem.kernel is not None else (req["hardware"], None)
            try:
                job = job_from_problem(
                    problem, hardware, budget=budget,
                    seed=req["seed"], searcher=req["searcher"],
                    device=device, card=hardware if device else None)
            except KeyError as exc:
                raise P.ProtocolError(f"unknown hardware: {exc}") from None
            return job, store_key(job.space.name, job.bucket,
                                  job.hardware_key, kind=job.kind)
        if req["kind"] == "kernel":
            from repro_torch.fleet import job_from_registry
            from repro_torch.kernels.registry import BENCHMARKS
            if req["kernel"] not in BENCHMARKS:
                raise P.ProtocolError(
                    f"unknown kernel {req['kernel']!r}; available: "
                    f"{sorted(BENCHMARKS)}", code=P.E_UNKNOWN_KERNEL)
            input_key = req["input"] if req["input"] is not None \
                else sorted(BENCHMARKS[req["kernel"]].inputs)[0]
            hardware, device = self._place(req["hardware"])
            try:
                job = job_from_registry(
                    req["kernel"], input_key, hardware,
                    budget=budget, seed=req["seed"],
                    searcher=req["searcher"], device=device,
                    card=hardware if device else None)
            except (KeyError, ValueError) as exc:
                raise P.ProtocolError(str(exc), code=P.E_UNKNOWN_KERNEL) \
                    from None
            return job, store_key(job.space.name, job.bucket,
                                  job.hardware_key, kind=job.kind)
        return self._build_serve_job(req, budget)

    def _build_serve_job(self, req: Dict[str, Any],
                         budget: int) -> Tuple[TuningJob, str]:
        """A serve-kind submit reconstructs the client's tuning problem as
        a ``ServeProblem``: the SAME space (so published model artifacts
        bind on the client side) and the portable serving workload at the
        client's explicit bucket shape, priced on the cost model with the
        client's feasibility rule, whatever the pool measures."""
        from repro_torch.fleet import job_from_problem
        from repro_torch.serve.autotune import ServeProblem
        if req["hardware_spec"] is not None:
            # hardware outside this daemon's registry (a replica's "cpu"
            # label, a lab card): price on the shipped spec numbers and
            # key the store by their fingerprint, like the fleet does
            try:
                hw = HardwareSpec(**req["hardware_spec"])
            except TypeError as exc:
                raise P.ProtocolError(f"bad hardware_spec: {exc}") \
                    from None
        else:
            try:
                hw = hwspec.get(req["hardware"])
            except KeyError as exc:
                raise P.ProtocolError(f"unknown hardware: {exc}") from None
        try:
            problem = ServeProblem(
                req["bucket"], batch_sizes=req["batch_sizes"],
                max_seqs=req["max_seqs"], space_name=req["space"],
                calib_n=req["calib_n"], stats=req["stats"],
                shape=tuple(req["bucket_shape"]))
        except ValueError as exc:
            raise P.ProtocolError(str(exc)) from None
        job = job_from_problem(
            problem,
            hw if req["hardware_spec"] is not None else req["hardware"],
            budget=budget, seed=req["seed"],
            name=f"serve:{req['bucket']}")   # renamed to the rid on accept
        return job, store_key(job.space.name, job.bucket,
                              job.hardware_key, kind=job.kind)

    def _place(self, hardware: str) -> Tuple[Union[str, HardwareSpec],
                                             Optional[str]]:
        """``(hardware, device)`` of one job.  Priced (device None) when
        the pool has no cards; otherwise the next card, in turn, of those
        whose spec has the request's hardware key, and that card's spec
        (which the job builder takes as the card's, detecting nothing).
        A measuring daemon with no card of the key refuses the request:
        it is measured on the hardware it names or not at all."""
        if not self.cards:
            return hardware, None
        key = hwspec.hardware_key(hardware)
        mine = [(d, spec) for d, spec in self.cards
                if hwspec.hardware_key(spec) == key]
        if not mine:
            have = ", ".join(f"{d} ({hwspec.hardware_key(spec)})"
                             for d, spec in self.cards)
            raise P.ProtocolError(
                f"no card of {key!r} here: this daemon measures on {have}, "
                "and a request is measured on the hardware it names, never "
                "priced in its place")
        turn = self._turns.get(key, 0)
        self._turns[key] = turn + 1
        device, spec = mine[turn % len(mine)]
        return spec, device
    def _op_status(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rec = self._records.get(req["request_id"])
        if rec is None:
            return P.err(f"unknown request {req['request_id']!r}",
                         code=P.E_UNKNOWN_REQUEST)
        return P.ok(**rec.status_dict())

    def _op_result(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rec = self._records.get(req["request_id"])
        if rec is None:
            return P.err(f"unknown request {req['request_id']!r}",
                         code=P.E_UNKNOWN_REQUEST)
        if rec.state == CANCELLED:
            return P.err(rec.error or "request was cancelled",
                         code=P.E_NOT_DONE, state=rec.state)
        if rec.state != DONE or rec.result is None:
            return P.err(f"request {rec.rid} is {rec.state}",
                         code=P.E_NOT_DONE, state=rec.state)
        return P.ok(request_id=rec.rid, state=DONE, **rec.result)

    def _op_cancel(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rec = self._records.get(req["request_id"])
        if rec is None:
            return P.err(f"unknown request {req['request_id']!r}",
                         code=P.E_UNKNOWN_REQUEST)
        if rec.state in (DONE, CANCELLED):
            return P.ok(request_id=rec.rid, state=rec.state,
                        cancelled=False)
        if rec.state in (QUEUED, PARKED):
            if rec.primary is None and rec.rid in self._pending:
                self._pending.remove(rec.rid)
            self._resolve_cancelled_rid(rec.rid, "cancelled by client")
        else:  # RUNNING: the fleet abandons its in-flight tests
            self.tuner.cancel_job(rec.rid)
        return P.ok(request_id=rec.rid, state=rec.state, cancelled=True)

    def _op_stats(self) -> Dict[str, Any]:
        by_state: Dict[str, int] = {}
        by_source: Dict[str, int] = {}
        for rec in self._records.values():
            by_state[rec.state] = by_state.get(rec.state, 0) + 1
            if rec.source is not None:
                by_source[rec.source] = by_source.get(rec.source, 0) + 1
        return P.ok(
            protocol=P.PROTOCOL, version=P.PROTOCOL_VERSION,
            draining=self._draining,
            fleet=self.tuner.progress(),
            tenants=self.tenants.snapshot(),
            requests=by_state,
            sources=by_source,
            transfers=by_source.get("transfer", 0),
            store_entries=len(self.store),
            gc=self.gc_stats,
            journal=(None if self.journal is None
                     else dict({"path": self.journal.path,
                                "appends": self.journal.appends,
                                "fsync_lag_s": round(
                                    self.journal.fsync_lag_s, 6)},
                               **self.journal.stats())),
            store_saves=getattr(self.store, "save_stats", None),
            recovery=self.recovery,
            **self._lanes(),
        )

    def _lanes(self) -> Dict[str, Any]:
        """``{"lanes": [...]}`` for a pool whose lanes report their device,
        card and kernel launches (``lane_info``), else nothing: a measuring
        pool's launches are read where the lanes run."""
        info = getattr(self.pool, "lane_info", None)
        return {"lanes": info()} if info is not None else {}

    def _op_health(self) -> Dict[str, Any]:
        """Liveness + readiness (the ``health``/heartbeat op).

        In-process driving (tests, recovery drills) has no loop thread;
        liveness then reports on the daemon state alone."""
        alive = self._loop_thread.is_alive() \
            if self._loop_thread is not None else not self._stopped.is_set()
        age = None if self._heartbeat is None \
            else time.monotonic() - self._heartbeat
        rep = H.assess(age, alive, self._draining, self.store,
                       self.journal)
        return P.ok(**rep.to_dict())

    # -- crash recovery --------------------------------------------------------
    def _recover(self) -> None:
        """Rebuild daemon state by replaying the write-ahead journal.

        Runs in the constructor, before any socket or loop exists:

        * resolved requests (``done``/``cancelled``) are restored so old
          request ids keep answering ``status``/``result``;
        * journaled results MISSING from the store are re-put (this is
          how a quarantined shard gets rebuilt from the journal);
        * unfinished requests are resubmitted through ``_build_job``
          with their remaining trial budget (journaled ``progress``
          checkpoints), re-coalescing identical keys; a request whose
          key reached the store before the crash is answered from it;
        * tenant budgets/spend are restored from ``submit`` payloads
          and ``charge`` records, so a restart cannot reset anyone's
          allowance.
        """
        events, jstats = self.journal.replay()
        seen: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        spend: Dict[str, float] = {}
        for ev in events:
            kind = ev.get("ev")
            rid = ev.get("rid")
            if kind == EV_SUBMIT and rid is not None:
                seen[rid] = {"req": ev.get("req") or {},
                             "key": ev.get("key"),
                             "idem": ev.get("idem"),
                             "state": QUEUED, "trials": 0,
                             "spent": 0.0, "result": None, "error": None}
                if rid not in order:
                    order.append(rid)
                try:
                    self._seq = max(self._seq, int(rid.lstrip("r")))
                except ValueError:
                    pass
            elif kind == EV_CHARGE:
                t = ev.get("tenant")
                if t is not None:
                    spend[t] = spend.get(t, 0.0) + float(ev.get("s", 0.0))
                if rid in seen:
                    seen[rid]["spent"] += float(ev.get("s", 0.0))
            elif kind == EV_PROGRESS and rid in seen:
                seen[rid]["trials"] = int(ev.get("trials", 0))
            elif kind == EV_DONE and rid in seen:
                seen[rid]["state"] = DONE
                seen[rid]["result"] = ev.get("result")
            elif kind == EV_CANCELLED and rid in seen:
                seen[rid]["state"] = CANCELLED
                seen[rid]["error"] = ev.get("error")
        stats = {"requests": len(order), "restored_done": 0,
                 "restored_cancelled": 0, "answered_from_store": 0,
                 "resubmitted": 0, "rebuild_failed": 0,
                 "repaired_entries": 0, "journal": jstats.to_dict()}
        # tenants first: budgets + spend survive the restart
        for rid in order:
            req = seen[rid]["req"]
            if req.get("tenant"):
                try:
                    ts = self.tenants.admit(
                        req["tenant"], budget_s=req.get("tenant_budget_s"))
                    ts.submitted += 1
                except AdmissionError:
                    pass             # smaller table post-restart: best effort
        for tenant, s in spend.items():
            ts = self.tenants.get(tenant)
            if ts is not None:
                self.tenants.charge(ts, s)
        # repair the store from journaled results it is missing (e.g. a
        # shard quarantined by a checksum failure)
        for rid in order:
            res = seen[rid]["result"]
            if seen[rid]["state"] != DONE or not res \
                    or not res.get("config") or not seen[rid]["key"]:
                continue
            kind, space, bucket, hw = split_key(seen[rid]["key"])
            if self.store.get(space, bucket, hw, kind=kind) is None:
                self.store.put(space, bucket, hw,
                               config=dict(res["config"]),
                               runtime=float(res["runtime"]),
                               trials=int(res.get("trials", 0)),
                               meta={"recovered": True, "rid": rid},
                               kind=kind)
                stats["repaired_entries"] += 1
        # rebuild the request table
        for rid in order:
            s = seen[rid]
            req = s["req"]
            rec = RequestRecord(
                rid=rid, tenant=req.get("tenant", "?"),
                kind=req.get("kind", "kernel"),
                key=s["key"] or "?|?|?|?",
                idem=s["idem"], recovered=True)
            self._records[rid] = rec
            if s["idem"] is not None and req.get("tenant"):
                self._idem[(req["tenant"], s["idem"])] = rid
            ts = self.tenants.get(rec.tenant)
            if s["state"] == DONE:
                rec.state = DONE
                rec.result = s["result"]
                rec.source = (s["result"] or {}).get("source")
                rec.trials = int((s["result"] or {}).get("trials", 0))
                rec.spent_s = s["spent"]
                stats["restored_done"] += 1
                continue
            if s["state"] == CANCELLED:
                rec.state = CANCELLED
                rec.error = s["error"] or "cancelled before daemon crash"
                stats["restored_cancelled"] += 1
                continue
            # unfinished at crash time: answer from the store if its key
            # landed, else resubmit with the remaining budget
            rec.spent_s = s["spent"]
            rec.resumed_trials = s["trials"]
            kind, space, bucket, hw = split_key(rec.key)
            entry = self.store.get(space, bucket, hw, kind=kind)
            if entry is not None:
                rec.state = DONE
                rec.source = "store"
                rec.result = {"key": rec.key,
                              "config": dict(entry.config),
                              "runtime": entry.runtime, "trials": 0,
                              "entry_trials": entry.trials,
                              "source": "store"}
                if ts is not None:
                    ts.store_hits += 1
                self._j(EV_DONE, rid=rid, result=rec.result,
                        spent=round(rec.spent_s, 9))
                stats["answered_from_store"] += 1
                continue
            try:
                job, _ = self._build_job(req)
            except (P.ProtocolError, KeyError, TypeError) as exc:
                rec.state = CANCELLED
                rec.error = f"recovery could not rebuild job: {exc}"
                self._j(EV_CANCELLED, rid=rid, error=rec.error)
                stats["rebuild_failed"] += 1
                continue
            job.budget = max(1, job.budget - rec.resumed_trials)
            rec.job = job
            primary = self._by_key.get(rec.key)
            if primary is not None:
                self._records[primary].followers.append(rid)
                rec.primary = primary
                rec.source = "coalesced"
            else:
                job.name = rid
                self._by_key[rec.key] = rid
                self._pending.append(rid)
            if ts is not None:
                ts.queued += 1
            stats["resubmitted"] += 1
        self.recovery = stats
        if self.verbose:
            print(f"[service] recovery: {stats}")

    # -- socket plumbing -------------------------------------------------------
    #
    # One selector-driven IO thread serves every connection.  The old
    # thread-per-connection reader convoyed on the GIL under a
    # multi-tenant submit storm (8 readers × small CPU bursts); a single
    # event loop removes that contention AND lets acks be *deferred*
    # instead of blocked-on: a response whose journal records are not
    # yet group-committed is parked on the connection's output queue and
    # flushed when the committer's fsync lands (the journal commit
    # listener pokes the loop's self-pipe).  The write-ahead guarantee —
    # no ack before durability — is upheld without any reader ever
    # sleeping in ``wait_durable``.  In-process callers keep using
    # ``handle()``, which still blocks.

    def _notify_io(self) -> None:
        """Journal commit listener: wake the IO loop (never blocks)."""
        try:
            os.write(self._wake_w, b"\0")
        except (OSError, ValueError):
            pass

    def _io_loop(self) -> None:
        sel = selectors.DefaultSelector()
        self._server.setblocking(False)
        sel.register(self._server, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        conns: set = set()
        server_open = True
        while True:
            try:
                ready = sel.select(timeout=0.5)
            except OSError:
                break
            # drain everything available before deciding the burst is
            # over: a storm's submits land as several TCP segments a
            # few tens of microseconds apart, and kicking the journal
            # between them would split one coalescable burst across
            # fsyncs (bounded passes keep the stop check responsive)
            for _ in range(64):
                if not ready:
                    break
                server_open = self._io_handle(sel, conns, ready,
                                              server_open)
                try:
                    ready = sel.select(timeout=0)
                except OSError:
                    ready = []
            # event queue drained with acks still parked on the journal:
            # no more records are imminent, so end the committer's
            # quiesce window — the whole burst goes into one fsync NOW
            if self.journal is not None:
                for cs in conns:
                    if cs.out:
                        self.journal.kick()
                        break
            if self._stopped.is_set() and not conns and not server_open:
                break
        sel.close()

    def _io_handle(self, sel, conns, ready, server_open: bool) -> bool:
        for key, events in ready:
            if key.data == "accept":
                server_open = self._io_accept(sel, conns)
            elif key.data == "wake":
                try:
                    os.read(self._wake_r, 4096)
                except (OSError, BlockingIOError):
                    pass
                for cs in list(conns):
                    if cs.out or cs.wbuf:
                        self._io_flush(sel, conns, cs)
            else:
                cs = key.data
                if events & selectors.EVENT_READ:
                    self._io_read(sel, conns, cs)
                if cs in conns and events & selectors.EVENT_WRITE:
                    self._io_flush(sel, conns, cs)
        return server_open

    def _io_accept(self, sel, conns) -> bool:
        """Accept every pending connection; False once the listening
        socket is gone (daemon stopping — existing conns live on)."""
        while True:
            try:
                sock, _ = self._server.accept()
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                try:
                    sel.unregister(self._server)
                except (KeyError, ValueError):
                    pass
                return False
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            cs = _ConnState(sock)
            sel.register(sock, selectors.EVENT_READ, cs)
            conns.add(cs)

    def _io_read(self, sel, conns, cs) -> None:
        try:
            data = cs.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._io_drop(sel, conns, cs)
            return
        if not data:
            # peer EOF: answer what was fully received, then close
            cs.closing = True
            if cs.rbuf and not cs.rbuf.endswith(b"\n"):
                cs.rbuf = b""        # torn trailing line: nothing to answer
        else:
            cs.rbuf += data
        while True:
            nl = cs.rbuf.find(b"\n")
            if nl < 0:
                if len(cs.rbuf) > P.MAX_LINE_BYTES:
                    self._io_protocol_error(cs)
                break
            line, cs.rbuf = cs.rbuf[:nl + 1], cs.rbuf[nl + 1:]
            if len(line) > P.MAX_LINE_BYTES:
                self._io_protocol_error(cs)
                break
            if not line.strip():
                continue
            self._io_request(cs, line)
        self._io_flush(sel, conns, cs)

    def _io_protocol_error(self, cs) -> None:
        """Oversize line: bounded-buffer refusal, then hang up (the rest
        of the oversize line dies with the connection)."""
        cs.out.append((0, P.encode(P.err(
            f"line exceeds {P.MAX_LINE_BYTES} bytes"))))
        cs.closing = True
        cs.rbuf = b""

    def _io_request(self, cs, line: bytes) -> None:
        """Dispatch one request line; queue its response behind the
        journal ticket covering the records it appended."""
        gate = 0
        try:
            req = P.validate_request(P.decode(line))
            with self._request_lock():
                resp = self._dispatch(req["op"], req)
                if self.journal is not None:
                    gate = self.journal.ticket()
        except P.ProtocolError as exc:
            resp, gate = P.err(str(exc), code=exc.code), 0
        except Exception as exc:        # never kill the IO loop
            resp = P.err(f"{type(exc).__name__}: {exc}", code=P.E_INTERNAL)
            gate = 0
        cs.out.append((gate, P.encode(resp)))

    def _io_flush(self, sel, conns, cs) -> None:
        """Move durable responses into the write buffer, push bytes,
        and keep the selector's write interest honest."""
        durable: Optional[int] = None
        while cs.out:
            gate, payload = cs.out[0]
            if gate:
                if durable is None:
                    durable = (self.journal.durable_upto()
                               if self.journal is not None else 0)
                if gate > durable:
                    err = (self.journal.commit_error()
                           if self.journal is not None else None)
                    if err is None:
                        break       # parked until the commit listener fires
                    payload = P.encode(P.err(
                        f"journal write failed: {err}", code=P.E_INTERNAL))
            cs.out.popleft()
            cs.wbuf += payload
        if cs.wbuf:
            try:
                sent = cs.sock.send(cs.wbuf)
                cs.wbuf = cs.wbuf[sent:]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._io_drop(sel, conns, cs)
                return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if cs.wbuf else 0)
        if want != cs.interest:
            try:
                sel.modify(cs.sock, want, cs)
                cs.interest = want
            except (KeyError, ValueError):
                pass
        if cs.closing and not cs.wbuf and not cs.out:
            self._io_drop(sel, conns, cs)

    @staticmethod
    def _io_drop(sel, conns, cs) -> None:
        try:
            sel.unregister(cs.sock)
        except (KeyError, ValueError):
            pass
        try:
            cs.sock.close()
        except OSError:
            pass
        conns.discard(cs)
