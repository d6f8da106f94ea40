"""``RequestJournal`` — the daemon's write-ahead request journal.

The store persists *outcomes*; the journal persists *promises*.  Every
wire-visible state transition of every request — accepted, dispatched,
partial-progress checkpoints, resolved, cancelled — plus every tenant
budget charge is appended to a JSON-lines file BEFORE the response that
acknowledges it goes back to the client (write-ahead discipline).  A
daemon that dies mid-tuning can then be restarted with ``--recover``:
replaying the journal reconstructs the request table, answers
already-finished requests from the store, resubmits interrupted jobs
with their remaining trial budget, and restores tenant spend — so a
crash costs at most the in-flight work, never the whole run.

Record format (one JSON object per line)::

    {"seq": 17, "ev": "submit", "rid": "r000003", ..., "crc": 2974301200}

``seq`` is monotonic per journal file; ``crc`` is the crc32 of the
record's canonical JSON *without* the crc field, so truncated or
bit-rotted lines are detected on replay.  Replay is forgiving by design:
a torn final record (the classic SIGKILL-mid-write artifact) is dropped
and counted, an interior record failing its checksum is skipped and
counted — the daemon must come back up on the journal a crash actually
left behind, not on the journal we wish it had.

Event vocabulary (the ``ev`` field)::

    daemon_start   one per daemon boot ({"recovered": bool})
    submit         accepted request: validated request payload + rid +
                   idempotency key (enough to rebuild the TuningJob)
    start          request entered the fleet
    progress       per-request checkpoint: trials completed so far
    charge         tenant budget charge (worker-seconds delta)
    done           request resolved: full result payload
    cancelled      request resolved without a result: reason

Durability modes (``mode=``)::

    always   every append is written + fsynced inline before it returns —
             a SIGKILL or machine crash loses at most the record being
             written.  The per-record fsync is also the cost: under a
             multi-tenant submit storm every ack pays a full disk flush.
    batch    GROUP COMMIT: appends are enqueued, one committer thread
             coalesces everything pending into a single write + fsync,
             and ``wait_durable(seq)`` blocks a caller only until the
             commit covering *its* record completes.  Acked records carry
             the same machine-crash durability as ``always`` (the ack is
             held until the fsync lands) at ~1 fsync per concurrent
             batch instead of per record.  Records appended without
             waiting (the daemon's progress/charge checkpoints) sit in
             process memory until the next commit, so a SIGKILL can lose
             an un-acked tail — never an acked one.
    off      write + flush, no fsync: a process kill still loses nothing
             (the OS holds the page), only a machine crash can.

``fsync_lag_s`` reports how long the oldest unsynced record has been
exposed, which the ``health`` op surfaces as a readiness signal;
``stats()`` exposes records/bytes/commit counts and the group-commit
batch sizes so the coalescing is inspectable.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

FORMAT = "repro.tuning-journal"
VERSION = 1

MODE_ALWAYS = "always"
MODE_BATCH = "batch"
MODE_OFF = "off"
MODES = (MODE_ALWAYS, MODE_BATCH, MODE_OFF)

# the ``ev`` values replay understands; unknown events are skipped (a
# newer daemon's journal should degrade, not crash, an older one)
EV_DAEMON_START = "daemon_start"
EV_SUBMIT = "submit"
EV_START = "start"
EV_PROGRESS = "progress"
EV_CHARGE = "charge"
EV_DONE = "done"
EV_CANCELLED = "cancelled"


def record_crc(record: Dict[str, Any]) -> int:
    """crc32 over the record's canonical JSON, excluding ``crc`` itself."""
    body = {k: v for k, v in record.items() if k != "crc"}
    return zlib.crc32(json.dumps(body, separators=(",", ":"),
                                 sort_keys=True).encode("utf-8"))


@dataclasses.dataclass
class ReplayStats:
    """What a journal replay found (and what it had to forgive)."""

    events: int = 0          # well-formed records yielded
    corrupt: int = 0         # interior records failing JSON/crc, skipped
    torn: int = 0            # truncated tail records dropped (SIGKILL scar)
    last_seq: int = 0        # highest seq seen (appends continue after it)

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def replay(path: str) -> Tuple[List[Dict[str, Any]], ReplayStats]:
    """Read every verifiable record from a journal file, in order.

    Never raises on a damaged journal: malformed/bad-crc lines are
    skipped (counted ``corrupt``, or ``torn`` when they form the
    file's tail — the expected scar of a kill mid-append).
    """
    events: List[Dict[str, Any]] = []
    stats = ReplayStats()
    if not os.path.exists(path):
        return events, stats
    bad_streak = 0           # trailing bad lines -> torn, interior -> corrupt
    with open(path, "rb") as f:
        for raw in f:
            try:
                rec = json.loads(raw.decode("utf-8"))
                if not isinstance(rec, dict) \
                        or rec.get("crc") != record_crc(rec):
                    raise ValueError("bad checksum")
            except (ValueError, UnicodeDecodeError):
                bad_streak += 1
                continue
            stats.corrupt += bad_streak   # bad lines had good ones after
            bad_streak = 0
            stats.events += 1
            stats.last_seq = max(stats.last_seq, int(rec.get("seq", 0)))
            events.append(rec)
    stats.torn = bad_streak
    return events, stats


class RequestJournal:
    """Append-only, checksummed JSON-lines journal bound to one file.

    ``append`` is thread-safe in every mode.  In ``always``/``off`` the
    record is written inline under the journal's internal lock; in
    ``batch`` it is enqueued for the committer thread, and callers that
    need the write-ahead guarantee block (``wait=True``, or an explicit
    ``wait_durable``) until the group commit covering their record has
    fsynced.  The daemon still serializes appends under its request lock,
    which keeps journal order matching response order — but it waits for
    durability *outside* that lock, which is what lets one fsync cover
    many concurrent requests.
    """

    def __init__(self, path: str, fsync: bool = True,
                 mode: Optional[str] = None,
                 batch_window_s: float = 0.0005,
                 batch_max_delay_s: float = 0.004):
        if mode is None:
            mode = MODE_ALWAYS if fsync else MODE_OFF
        if mode not in MODES:
            raise ValueError(
                "unknown journal mode %r (valid modes: %s)"
                % (mode, ", ".join(MODES)))
        self.path = path
        self.mode = mode
        self.fsync = mode != MODE_OFF   # back-compat readers
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._seq = 0                 # last seq assigned
        self._durable = 0             # last seq the disk is known to hold
        self._pending: List[bytes] = []   # encoded records awaiting commit
        self._pending_upto = 0        # seq of the last pending record
        self._appends = 0
        self._bytes = 0
        self._commits = 0             # fsync-bearing writes issued
        self._last_batch = 0          # records covered by the last commit
        self._max_batch = 0
        self._oldest_unsynced: Optional[float] = None
        self._io_error: Optional[BaseException] = None
        self._closed = False
        self._listeners: List[Any] = []   # called (no args) after commits
        # group-commit pacing: absorb arrivals while they keep coming
        # (one quiet ``batch_window_s`` ends the batch), never delaying
        # the fsync more than ``batch_max_delay_s`` past the first record
        self._window = max(float(batch_window_s), 0.0)
        self._max_delay = max(float(batch_max_delay_s), self._window)
        self._kicked = False
        self._committer: Optional[threading.Thread] = None
        if mode == MODE_BATCH:
            self._committer = threading.Thread(
                target=self._commit_loop, name="journal-committer",
                daemon=True)
            self._committer.start()

    def replay(self) -> Tuple[List[Dict[str, Any]], ReplayStats]:
        """Replay this journal's existing records; future appends
        continue after the highest sequence number found."""
        events, stats = replay(self.path)
        with self._lock:
            self._seq = max(self._seq, stats.last_seq)
            self._durable = max(self._durable, stats.last_seq)
        return events, stats

    def append(self, ev: str, wait: bool = True,
               **fields: Any) -> Dict[str, Any]:
        """Append one record; returns it (with ``seq`` assigned).

        ``wait=True`` (the default) upholds the write-ahead guarantee:
        the call does not return until the record is as durable as the
        mode promises.  ``wait=False`` enqueues and returns immediately
        in ``batch`` mode (use for checkpoints whose ack does not
        depend on them); it is identical to ``wait=True`` in the inline
        modes.
        """
        line: bytes
        with self._lock:
            if self._io_error is not None:
                raise self._io_error
            self._seq += 1
            record: Dict[str, Any] = {"seq": self._seq, "ev": ev,
                                      "t": round(time.time(), 6)}
            record.update(fields)
            # one serialization serves both: the crc is computed over the
            # canonical body and spliced onto the line's tail (replay
            # re-canonicalizes the parsed dict, so on-disk key order is
            # free) — dumps is the hot path's single biggest line item,
            # and record_crc() would pay it a second time per record
            body = json.dumps(record, separators=(",", ":"), sort_keys=True)
            crc = zlib.crc32(body.encode("utf-8"))
            record["crc"] = crc
            line = (body[:-1] + ',"crc":' + str(crc)
                    + "}\n").encode("utf-8")
            self._appends += 1
            self._bytes += len(line)
            if self.mode == MODE_BATCH:
                first = not self._pending
                self._pending.append(line)
                self._pending_upto = record["seq"]
                if self._oldest_unsynced is None:
                    self._oldest_unsynced = time.monotonic()
                if first:
                    # later records of a burst ride the same commit; only
                    # the first needs to rouse the committer (its quiesce
                    # wait polls growth, and ``kick`` ends it early), so
                    # a storm isn't one context switch per record
                    self._cond.notify_all()
                seq = record["seq"]
            else:
                self._f.write(line)
                self._f.flush()
                if self.mode == MODE_ALWAYS:
                    os.fsync(self._f.fileno())
                    self._commits += 1
                    self._last_batch = 1
                    self._max_batch = max(self._max_batch, 1)
                    self._durable = record["seq"]
                    self._oldest_unsynced = None
                elif self._oldest_unsynced is None:
                    self._oldest_unsynced = time.monotonic()
                return record
        if wait:
            self.wait_durable(seq)
        return record

    def ticket(self) -> int:
        """Sequence number of the newest enqueued record.  Pass to
        ``wait_durable`` to block until everything enqueued so far —
        including records appended with ``wait=False`` — is on disk."""
        with self._lock:
            return self._seq

    def durable_upto(self) -> int:
        """Highest seq an ack may be released for right now.

        In the inline modes every append is already as durable as the
        mode promises when it returns, so this is simply the last seq
        assigned; in ``batch`` it is the last group-committed seq.  An
        event-driven server checks this instead of blocking in
        ``wait_durable`` — see ``add_commit_listener``.
        """
        with self._lock:
            if self.mode != MODE_BATCH:
                return self._seq
            return self._durable

    def commit_error(self) -> Optional[BaseException]:
        """The committer's fatal IO error, if it died (batch mode)."""
        return self._io_error

    def add_commit_listener(self, fn) -> None:
        """Register a zero-arg callback fired after every group commit
        (and on committer failure/close).  Called from the committer
        thread OUTSIDE the journal lock; must not block — the daemon's
        IO loop registers a self-pipe write here so deferred acks flush
        as soon as the fsync covering them lands."""
        with self._lock:
            self._listeners.append(fn)

    def _notify_listeners(self) -> None:
        for fn in list(self._listeners):
            try:
                fn()
            except Exception:
                pass

    def kick(self) -> None:
        """End the committer's quiesce window now: whatever is pending
        goes into the next fsync immediately.  The daemon's IO loop
        calls this the moment its event queue drains while acks are
        still parked on the journal — the server knows no more records
        are imminent, so waiting out the quiet window is pure latency.
        No-op outside ``batch`` mode or with nothing pending."""
        if self.mode != MODE_BATCH:
            return
        with self._cond:
            if self._pending:
                self._kicked = True
                self._cond.notify_all()

    def wait_durable(self, seq: int) -> None:
        """Block until record ``seq`` is covered by an fsync (batch
        mode) or already written (inline modes; returns immediately)."""
        if self.mode != MODE_BATCH:
            return
        with self._cond:
            while self._durable < seq and self._io_error is None \
                    and not self._closed:
                self._cond.wait(timeout=1.0)
            if self._durable < seq and self._io_error is not None:
                raise self._io_error

    def _commit_loop(self) -> None:
        """Committer thread: coalesce everything pending into one
        write + fsync, then wake every caller that commit covers."""
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                # quiesce pacing: a burst's records arrive a few tens of
                # microseconds apart — keep absorbing while they keep
                # coming, so one fsync covers the whole burst instead of
                # racing it one-or-two records at a time.  A quiet
                # window ends the batch; ``_max_delay`` bounds how stale
                # the first record may go under a continuous trickle.
                if self._window > 0.0 and not self._closed \
                        and not self._kicked:
                    deadline = time.monotonic() + self._max_delay
                    last = self._pending_upto
                    while time.monotonic() < deadline:
                        self._cond.wait(self._window)
                        if self._closed or self._kicked \
                                or self._pending_upto == last:
                            break
                        last = self._pending_upto
                batch = self._pending
                upto = self._pending_upto
                self._pending = []
                self._kicked = False
            try:
                self._f.write(b"".join(batch))
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError) as exc:   # ValueError: closed file
                with self._cond:
                    self._io_error = exc
                    self._cond.notify_all()
                self._notify_listeners()
                return
            with self._cond:
                self._durable = max(self._durable, upto)
                self._commits += 1
                self._last_batch = len(batch)
                self._max_batch = max(self._max_batch, len(batch))
                if not self._pending:
                    self._oldest_unsynced = None
                self._cond.notify_all()
            self._notify_listeners()

    def sync(self) -> None:
        """Force the unsynced tail to disk (no-op when already clean)."""
        if self.mode == MODE_BATCH:
            self.wait_durable(self.ticket())
            return
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._durable = self._seq
            self._oldest_unsynced = None

    @property
    def appends(self) -> int:
        return self._appends

    @property
    def fsync_lag_s(self) -> float:
        """Seconds the oldest unsynced record has been exposed (0: clean)."""
        if self._oldest_unsynced is None:
            return 0.0
        return time.monotonic() - self._oldest_unsynced

    def stats(self) -> Dict[str, Any]:
        """Counters that make the batching inspectable: total records
        and bytes appended, fsync-bearing commits, and how many records
        the last/largest group commit coalesced."""
        with self._lock:
            return {
                "mode": self.mode,
                "records": self._appends,
                "bytes": self._bytes,
                "commits": self._commits,
                "last_batch": self._last_batch,
                "max_batch": self._max_batch,
                "pending": len(self._pending),
            }

    def close(self) -> None:
        committer = self._committer
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if committer is not None and committer.is_alive() \
                and committer is not threading.current_thread():
            committer.join(timeout=5.0)
        self._notify_listeners()
        try:
            with self._lock:
                if self._pending:   # committer died/timed out: best effort
                    self._f.write(b"".join(self._pending))
                    self._pending = []
                self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
