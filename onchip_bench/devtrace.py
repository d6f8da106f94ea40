"""The traced run's reading of the card: the seconds in which an operation
ran on the device within the window, the operations that took the most
time, and the idle gaps by what the host was doing in them (inside the
searcher's or the evaluator's calls, else the harness's own code)."""
from __future__ import annotations

import bisect
import contextlib
from typing import Callable, Dict, List, Tuple

TOP = 10


class Tracer:
    """torch.profiler's CUDA activity over the window, and the host clock's
    reading just before a marker is launched on the idle card at its
    start: the marker is the trace's first operation, and places the host's
    intervals on the card's timeline."""

    def __init__(self, prof, mark: float):
        self.prof = prof
        self.mark = mark


@contextlib.contextmanager
def traced(active: bool, on_card: bool, clock: Callable[[], float]):
    """A ``Tracer`` over the block when ``active`` (with no profiler off a
    card), else None.  The profiler records the card's operations only:
    recording the host's operators as well slows each launch enough to move
    the evaluator's own timings."""
    if not active:
        yield None
        return
    if not on_card:
        yield Tracer(None, clock())
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        mark = clock()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        yield Tracer(prof, mark)
        torch.cuda.synchronize()


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval of ``busy`` (merged) covers."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


def attribute(gaps, spans: List[Tuple[float, float, str]]
              ) -> List[Tuple[str, float]]:
    """Each gap with the host layer whose range holds its midpoint."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        layer = spans[i][2] if i >= 0 and spans[i][1] >= mid else "harness"
        out.append((layer, (b - a) * 1e-6))
    return out


def summarize(device: List[Tuple[float, float, str]],
              host: List[Tuple[float, float, str]],
              window: Tuple[float, float]) -> Dict:
    """Busy seconds, the top device operations and the idle gaps from
    intervals in microseconds: ``device`` and ``host`` as (start, end,
    name), ``window`` as (start, end)."""
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    busy = union([(a, b) for a, b, _ in inside])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name: Dict[str, float] = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = attribute(idle_gaps(busy, lo, hi), host)
    totals: Dict[str, List[float]] = {}
    for layer, s in gaps:
        t = totals.setdefault(layer, [0, 0.0])
        t[0] += 1
        t[1] += s
    grouped = [[f"{layer}: {n} gaps", s] for layer, (n, s) in
               sorted(totals.items(), key=lambda kv: -kv[1][1])]
    longest = [[f"{layer}: one gap", s] for layer, s in
               sorted(gaps, key=lambda g: -g[1])]
    return {"busy_s": busy_s, "window_s": (hi - lo) * 1e-6,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": (grouped + longest)[:TOP]}}


def read(tracer: Tracer, intervals, start: float, end: float) -> Dict:
    """``summarize`` of a finished ``Tracer``, with the host's ``intervals``
    (start, end, layer) and the window [``start``, ``end``] on the host's
    clock; ``events`` is the count of the card's operations in the trace."""
    from torch.autograd import DeviceType

    device = []
    if tracer.prof is not None:
        # the profiler's raw events: building its FunctionEvents for some
        # hundred thousand launches takes minutes
        results = tracer.prof.profiler.kineto_results
        device = [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
                  for e in results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()]
    origin = min((a for a, _, _ in device), default=0.0)

    def us(t: float) -> float:
        return (t - tracer.mark) * 1e6 + origin

    host = [(us(a), us(b), layer) for a, b, layer in intervals]
    out = summarize(device, host, (us(start), us(end)))
    out["events"] = len(device)
    return out
