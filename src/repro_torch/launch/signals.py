"""Graceful-drain signal handling shared by the long-running CLIs.

Both the fleet CLI and a long-running daemon want the same SIGINT/SIGTERM
contract: the FIRST signal requests a drain (stop filling, let in-flight
empirical tests finish, publish/report what completed), a SECOND signal
gives up and restores the default handler so the third one kills the
process the ordinary way.  ``install_drain_handlers`` encodes exactly
that; the drain callback must be safe to call from a signal handler
(set a flag, or call ``FleetTuner.stop()``, which only flips one — never
block there).
"""
from __future__ import annotations

import signal
import sys
from typing import Callable, Iterable

DRAIN_SIGNALS = (signal.SIGINT, signal.SIGTERM)


def install_drain_handlers(drain: Callable[[], None],
                           signals: Iterable[int] = DRAIN_SIGNALS,
                           verbose: bool = True) -> Callable[[], bool]:
    """Route ``signals`` to ``drain()`` (once); return a ``draining()`` probe.

    The first delivery calls ``drain`` and keeps running; the second
    restores ``SIG_DFL`` for all registered signals — so a stuck drain
    can still be interrupted — and re-raises the default behavior on the
    next delivery.  Returns a zero-arg callable reporting whether a
    drain was requested (CLIs use it to annotate their reports).
    """
    state = {"drains": 0}
    sigs = tuple(signals)

    def handler(signum, frame):
        state["drains"] += 1
        if state["drains"] == 1:
            if verbose:
                print(f"\n[signal] {signal.Signals(signum).name}: draining "
                      f"in-flight work (signal again to force quit)",
                      file=sys.stderr)
            drain()
            return
        if verbose:
            print(f"\n[signal] {signal.Signals(signum).name} again: "
                  f"restoring default handlers", file=sys.stderr)
        for s in sigs:
            signal.signal(s, signal.SIG_DFL)

    for s in sigs:
        signal.signal(s, handler)
    return lambda: state["drains"] > 0
