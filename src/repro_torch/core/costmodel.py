"""Analytic execution model: PC_ops × HardwareSpec → runtime + PC_stress.

The same first-order model as the JAX package's, term for term, on the
Hopper vocabulary, so the two can be held against each other on identical
numbers:

  * fp32 and int pipes issue separately (dual issue — Volta analogy §3.5.1),
    special functions share the int pipe's slow path;
  * a block's working set must fit shared memory; 2x (double buffering) is
    needed to overlap loads with compute, otherwise they serialize;
  * working set beyond shared-memory capacity spills to device memory
    (read + write round trip) — the local-memory term of paper Eq. 8;
  * fewer blocks than SMs leaves SMs idle; fewer than
    LATENCY_HIDING_PROGRAMS per SM fails to hide launch/load latency;
  * tile-padding lane waste derates the fp32 rate (warp efficiency);
  * NVLink traffic overlaps with compute only when double-buffered.

``execute`` is ``f : TP x I x GPU -> PC`` of the paper (Eq. 2) with a
modelled runtime.  ``stress_from_runtime`` gives the stress counters of a
runtime measured on the card instead (``DeviceKernelEvaluator``).
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.hwspec import HardwareSpec

# Blocks per SM needed to hide launch/load latency.  The value is the JAX
# package's, kept so the two models agree number for number; the paper's
# GPU value (5 threads per core, Eq. 14) is queued in ROADMAP.md.
LATENCY_HIDING_PROGRAMS = 4


def _pipe_times(ops: Dict[str, float], hw: HardwareSpec) -> Dict[str, float]:
    """Per-subsystem busy times (seconds, whole kernel) and the terms they
    are built from."""
    grid = max(1.0, float(ops.get(C.CTAS, 1.0)))
    ws = float(ops.get(C.SMEM_WS, 0.0))
    warp_e = float(ops.get(C.WARP_E_HINT, 1.0))

    # hardware-true spill (overrides the portable estimate)
    spill_per_prog = max(0.0, ws - hw.smem_bytes)
    spill_bytes = max(float(ops.get(C.LOCAL_B, 0.0)),
                      2.0 * spill_per_prog * grid)

    sms = float(hw.sms)
    if grid < sms:
        sm_e = grid / sms
    else:
        waves = math.ceil(grid / sms)
        sm_e = grid / (waves * sms)  # tail-wave imbalance

    eff_fp32 = hw.fp32_flops * sm_e * max(warp_e, 1e-3)
    return dict(
        grid=grid, ws=ws, warp_e=warp_e, spill_bytes=spill_bytes, sm_e=sm_e,
        fp32=float(ops.get(C.FP32_FLOPS, 0.0)) / eff_fp32,
        int=float(ops.get(C.INT_OPS, 0.0)) / (hw.int_ops * sm_e),
        sfu=float(ops.get(C.SFU_OPS, 0.0)) / (hw.sfu_ops * sm_e),
        dram=(float(ops.get(C.DRAM_RD, 0.0)) + float(ops.get(C.DRAM_WR, 0.0))
              + spill_bytes) / hw.dram_bw,
        smem=(float(ops.get(C.SMEM_RD, 0.0))
              + float(ops.get(C.SMEM_WR, 0.0))) / hw.smem_bw,
        const=float(ops.get(C.CONST_RD, 0.0)) / hw.const_bw,
        nvlink=float(ops.get(C.NVLINK_B, 0.0)) / hw.nvlink_card_bw,
    )


def execute(ops: Dict[str, float], hw: HardwareSpec) -> C.CounterSet:
    """Run the analytic machine: ops counters -> (runtime, stress counters).

    ``ops`` are kernel totals (bytes / flops / block counts) as produced by a
    kernel's workload model.  ``LOCAL_B`` may be 0 in the portable view; the
    true spill for *this* hardware's shared-memory capacity is recomputed
    here (cache-capacity effect, paper §3.1 imprecision note).
    """
    t = _pipe_times(ops, hw)
    grid, ws = t["grid"], t["ws"]
    t_exec = max(t["fp32"], t["int"] + t["sfu"])          # dual-issue pipes
    t_mem = max(t["dram"], t["smem"], t["const"])
    t_nvlink = t["nvlink"]

    sms = float(hw.sms)
    double_buffered = ws > 0 and 2.0 * ws <= hw.smem_bytes
    programs_per_sm = grid / sms
    latency_hidden = programs_per_sm >= LATENCY_HIDING_PROGRAMS

    t_launch = hw.launch_latency * grid / max(1.0, min(grid, sms))
    if double_buffered:
        t_body = max(t_exec, t_mem, t_nvlink)
    else:
        # loads cannot overlap compute; NVLink still uses its own fabric
        t_body = t_exec + t_mem + max(0.0, t_nvlink - t_exec - t_mem)
        t_body = max(t_body, t_nvlink)
    if not latency_hidden:
        t_launch += hw.launch_latency * max(
            0.0, LATENCY_HIDING_PROGRAMS - programs_per_sm
        )
    runtime = t_body + t_launch
    runtime = max(runtime, 1e-9)
    return stress_from_runtime(ops, hw, runtime)


def stress_from_runtime(ops: Dict[str, float], hw: HardwareSpec,
                        runtime: float) -> C.CounterSet:
    """Counters of a kernel that took ``runtime`` seconds: each subsystem's
    busy time (from ``ops`` and ``hw``) over the runtime.

    ``execute`` passes its modelled runtime; the card evaluator passes the
    measured one.  ``LOCAL_B`` in the result is the hardware-true spill.
    """
    t = _pipe_times(ops, hw)
    t_fp32, t_int, t_sfu = t["fp32"], t["int"], t["sfu"]
    stress = {
        C.DRAM_U: min(1.0, t["dram"] / runtime),
        C.SMEM_U: min(1.0, t["smem"] / runtime),
        C.CONST_U: min(1.0, t["const"] / runtime),
        C.NVLINK_U: min(1.0, t["nvlink"] / runtime),
        C.FP32_U: min(1.0, t_fp32 / runtime),
        C.INT_U: min(1.0, t_int / runtime),
        C.SFU_U: min(1.0, t_sfu / runtime),
        # dual pipe: 1.0 == both pipes saturated; 0.5 == one pipe saturated
        C.ISSUE_U: min(1.0, (min(1.0, t_fp32 / runtime)
                             + min(1.0, (t_int + t_sfu) / runtime)) / 2.0),
        C.SM_E: t["sm_e"],
        C.WARP_E: t["warp_e"],
        C.OCCUPANCY: min(1.0, t["ws"] / hw.smem_bytes) if hw.smem_bytes
        else 0.0,
    }
    ops_out = {k: float(v) for k, v in ops.items() if k in C.PC_OPS}
    ops_out[C.LOCAL_B] = t["spill_bytes"]
    return C.CounterSet(ops=ops_out, stress=stress, runtime=runtime)
