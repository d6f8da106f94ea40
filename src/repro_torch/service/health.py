"""Liveness + readiness probes for the tuning daemon's ``health`` op.

Kubernetes-style split: *live* means the process is making progress (the
fleet loop has ticked recently — a wedged loop with an open socket is
dead, not alive), *ready* means it can usefully accept work (not
draining, the store's directory is writable, the journal's unsynced tail
is bounded).  ``ServiceClient.health()`` reads this to decide whether to
keep a reconnecting request parked or fail it over; load balancers in
front of multiple daemons get the same answer for free.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

# a fleet loop silent for this long is presumed wedged (its bounded
# step/wait cadence is ~0.25s, so 10s is ~40 missed ticks)
LOOP_STALL_S = 10.0

# an unsynced journal tail older than this flags the disk, not the load
JOURNAL_LAG_S = 5.0


@dataclasses.dataclass
class HealthReport:
    """One ``health`` op answer (flat, wire-friendly)."""

    live: bool
    ready: bool
    fleet_loop_alive: bool
    store_writable: bool
    draining: bool
    journal_enabled: bool
    journal_fsync_lag_s: float = 0.0
    journal_appends: int = 0
    journal_mode: Optional[str] = None
    journal_commits: int = 0       # fsync-bearing writes (group commits)
    journal_pending: int = 0       # enqueued records awaiting a commit
    loop_age_s: Optional[float] = None   # seconds since the last loop tick
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["journal_fsync_lag_s"] = round(self.journal_fsync_lag_s, 6)
        if self.loop_age_s is not None:
            d["loop_age_s"] = round(self.loop_age_s, 6)
        return d


def store_writable(store) -> bool:
    """Can the store's backing location take a write right now?

    Probes by creating and removing a sidecar file next to the store
    (never touching the store files themselves).  An in-memory store
    (``path is None``) has nothing to fail and reports True.
    """
    path = getattr(store, "path", None)
    if path is None:
        return True
    root = path if os.path.isdir(path) \
        else (os.path.dirname(os.path.abspath(path)) or ".")
    probe = os.path.join(root, f".health_probe.{os.getpid()}")
    try:
        fd = os.open(probe, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        os.write(fd, b"ok")
        os.close(fd)
        os.unlink(probe)
        return True
    except OSError:
        return False


def assess(loop_age_s: Optional[float], loop_thread_alive: bool,
           draining: bool, store, journal=None) -> HealthReport:
    """Fold the daemon's raw signals into one report.

    ``loop_age_s`` is None when the daemon is driven in-process (tests)
    without its loop thread — liveness then falls back to the thread
    flag alone, which the caller sets True for in-process driving.
    """
    loop_ok = loop_thread_alive and (loop_age_s is None
                                     or loop_age_s < LOOP_STALL_S)
    writable = store_writable(store)
    lag = journal.fsync_lag_s if journal is not None else 0.0
    ready = loop_ok and writable and not draining \
        and lag < JOURNAL_LAG_S
    detail = []
    if not loop_thread_alive:
        detail.append("fleet loop not running")
    elif loop_age_s is not None and loop_age_s >= LOOP_STALL_S:
        detail.append(f"fleet loop silent {loop_age_s:.1f}s")
    if not writable:
        detail.append("store not writable")
    if draining:
        detail.append("draining")
    if lag >= JOURNAL_LAG_S:
        detail.append(f"journal fsync lag {lag:.1f}s")
    jstats: Dict[str, Any] = {}
    if journal is not None and hasattr(journal, "stats"):
        jstats = journal.stats()
    return HealthReport(
        live=loop_ok, ready=ready, fleet_loop_alive=loop_thread_alive,
        store_writable=writable, draining=draining,
        journal_enabled=journal is not None,
        journal_fsync_lag_s=lag,
        journal_appends=journal.appends if journal is not None else 0,
        journal_mode=jstats.get("mode",
                                getattr(journal, "mode", None)),
        journal_commits=int(jstats.get("commits", 0)),
        journal_pending=int(jstats.get("pending", 0)),
        loop_age_s=loop_age_s,
        detail="; ".join(detail))
