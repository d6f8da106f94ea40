"""The benchmark's frozen yardstick: the kernel timing loop, the roofline
bound and the published peaks it divides by.

These are copies, kept here so that no change to the program moves them:
``time_ms`` is ``chip_smoke.py``'s ``time_ms``, ``bound_ms`` its ``bound``
and ``attention_pairs`` its ``_attention_pairs``, with the peaks read from
``peaks.json`` beside this file instead of the program's hardware specs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Tuple

# Bytes zeroed before each timed launch, so that the launch finds the L2
# cache (50 MB on the H100) holding none of its operands.
FLUSH_BYTES = 128 * 2**20
SWEEP_REPS = 20

PEAKS: Dict = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def time_ms(fn: Callable[[], object], reps: int = SWEEP_REPS,
            flush=None) -> float:
    """Median of ``reps`` calls of ``fn``, each timed with CUDA events around
    the call alone, after one warm-up call; ``flush`` is zeroed before each
    call so that L2 holds none of the operands.  (From ``chip_smoke.py``'s
    ``time_ms``.)"""
    import torch

    fn()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def warm_up(fn: Callable[[], object], flush, seconds: float = 1.0) -> None:
    """Calls of ``fn``, each after a flush, for ``seconds``: the card's
    clocks rise under sustained work, and the first configurations of a
    sweep made from an idle card read slower than the rest."""
    import time

    import torch

    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(10):
            flush.zero_()
            fn()
        torch.cuda.synchronize()


def bound_ms(work: Tuple[float, float, float, float]) -> Dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate of their unit.  Products that can run on the tensor cores
    take the faster of two routes to fp32 accuracy: the fp32 pipes, or three
    TF32 passes (3xTF32) at the dense TF32 rate.  ``work`` is (bytes, fp32
    operations, rsqrt or exp, the operations of its products that can run
    by 3xTF32).  (From ``chip_smoke.py``'s ``bound``.)"""
    nbytes, fp32, sfu, tensor = work
    times = {"bytes (dram_bw)": nbytes / PEAKS["dram_bw"] * 1e3,
             "fp32 (fp32_flops)": fp32 / PEAKS["fp32_flops"] * 1e3,
             "rsqrt or exp (sfu_ops)": sfu / PEAKS["sfu_ops"] * 1e3}
    routes = dict(times)
    if tensor:
        times["3xTF32 (tf32_flops)"] = 3.0 * tensor / PEAKS["tf32_flops"] \
            * 1e3
        slower = max(("fp32 (fp32_flops)", "3xTF32 (tf32_flops)"),
                     key=times.get)
        routes = {k: v for k, v in times.items() if k != slower}
    unit = max(routes, key=routes.get)
    return {"bound_ms": times[unit],
            "bound_by": "bytes" if unit.startswith("bytes") else "operations",
            "bound_unit": unit, "bound_terms_ms": times}


def attention_pairs(batch: int, heads: int, seq: int, causal: bool) -> float:
    """(query, key) pairs the function needs: S(S+1)/2 a head when causal.
    (From ``chip_smoke.py``'s ``_attention_pairs``.)"""
    per_head = seq * (seq + 1) / 2 if causal else seq ** 2
    return float(batch * heads * per_head)


def roofline_percent(kernel: str, ctx):
    """The kernel's bound over the best time of the set-up sweep (CUDA
    events, ``time_ms``), in percent; None where the cell tunes another
    kernel.  Each ``metrics/<kernel>_roofline.py`` reads it."""
    if ctx.kernel != kernel:
        return None
    return 100.0 * ctx.bound["bound_ms"] / float(ctx.sweep_ms.min())
