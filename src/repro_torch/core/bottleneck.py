"""Expert system, part 1: performance counters → bottleneck vector B.

Paper §3.5.1 (Eqs. 6–14) on the Hopper counters.  The equations and
constants are the JAX package's, counter for counter under
``counters.TPU_NAMES``, so the two packages analyse a sample identically.
Bottleneck values live in [0, 1]: 0 = subsystem unstressed, 1 = at
theoretical peak.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.counters import CounterSet

# Bottleneck keys (in the JAX package's order)
B_DRAM_READ = "b_dram_read"
B_DRAM_WRITE = "b_dram_write"
B_SMEM_READ = "b_smem_read"
B_SMEM_WRITE = "b_smem_write"
B_CONST = "b_const"
B_LOCAL = "b_local"
B_NVLINK = "b_nvlink"
B_FP32 = "b_fp32"
B_INT = "b_int"
B_SFU = "b_sfu"
B_ISSUE = "b_issue"
B_SM = "b_sm"          # paper b_sm (Eq. 13)
B_PARAL = "b_paral"    # paper Eq. 14

ALL_BOTTLENECKS = (
    B_DRAM_READ, B_DRAM_WRITE, B_SMEM_READ, B_SMEM_WRITE, B_CONST, B_LOCAL,
    B_NVLINK, B_FP32, B_INT, B_SFU, B_ISSUE, B_SM, B_PARAL,
)

# Blocks wanted per SM in Eq. 14.  The paper uses 5 threads per core on GPUs;
# this is the JAX package's value, kept while golden parity with it is the
# anchor (the paper's constant is queued in ROADMAP.md).
PROGRAMS_PER_CORE = 4


def _rw_split(read: float, write: float, util: float) -> tuple:
    tot = read + write
    if tot <= 0.0:
        return 0.0, 0.0
    return read / tot * util, write / tot * util


def analyze(pc: CounterSet, cores: int) -> Dict[str, float]:
    """Compute the bottleneck vector B from one profiled sample.

    ``cores`` is the SM count of the *autotuning* hardware (the bottleneck
    component always analyzes the device the kernel actually ran on — paper
    §3.3).
    """
    b: Dict[str, float] = {k: 0.0 for k in ALL_BOTTLENECKS}

    # --- memory subsystems (Eqs. 6-7 pattern) ---------------------------------
    b[B_DRAM_READ], b[B_DRAM_WRITE] = _rw_split(
        pc.op(C.DRAM_RD), pc.op(C.DRAM_WR), pc.st(C.DRAM_U)
    )
    b[B_SMEM_READ], b[B_SMEM_WRITE] = _rw_split(
        pc.op(C.SMEM_RD), pc.op(C.SMEM_WR), pc.st(C.SMEM_U)
    )
    # texture/constant path: read-only — utilization as-is
    b[B_CONST] = pc.st(C.CONST_U)

    # --- spill (local memory, Eq. 8) ------------------------------------------
    mem_bytes = pc.op(C.DRAM_RD) + pc.op(C.DRAM_WR) + pc.op(C.LOCAL_B)
    spill_frac = pc.op(C.LOCAL_B) / mem_bytes if mem_bytes > 0 else 0.0
    b[B_LOCAL] = spill_frac * max(pc.st(C.DRAM_U), pc.st(C.SMEM_U),
                                  pc.st(C.CONST_U))

    # --- interconnect -----------------------------------------------------------
    b[B_NVLINK] = pc.st(C.NVLINK_U)

    # --- instruction utilizations (Eqs. 9-11) ---------------------------------
    # ins_fitted: issued instructions corrected by warp execution efficiency
    issued = pc.op(C.INST_ISSUED)
    if issued <= 0.0:
        issued = pc.op(C.FP32_FLOPS) + pc.op(C.INT_OPS) + pc.op(C.SFU_OPS)
    warp_e = max(pc.st(C.WARP_E, 1.0), 1e-6)
    ins_fitted = issued / warp_e if issued > 0 else 1.0

    # dual-issue rule (paper: Volta issues int and fp separately -> /50%)
    ins_util = min(1.0, pc.st(C.ISSUE_U) / 0.5)

    frac_fp32 = pc.op(C.FP32_FLOPS) / ins_fitted if ins_fitted > 0 else 0.0
    frac_int = pc.op(C.INT_OPS) / ins_fitted if ins_fitted > 0 else 0.0
    frac_sfu = pc.op(C.SFU_OPS) / ins_fitted if ins_fitted > 0 else 0.0
    b[B_FP32] = min(1.0, frac_fp32) * ins_util
    b[B_INT] = min(1.0, frac_int) * ins_util
    b[B_SFU] = min(1.0, frac_sfu) * ins_util

    # --- issue-slot starvation (Eq. 12) ----------------------------------------
    util_max = min(1.0, max(frac_fp32, frac_int, frac_sfu))
    b[B_ISSUE] = util_max * (1.0 - pc.st(C.ISSUE_U))

    # --- parallelism (Eqs. 13-14) -----------------------------------------------
    b[B_SM] = 1.0 - pc.st(C.SM_E)
    target = cores * PROGRAMS_PER_CORE
    grid = pc.op(C.CTAS, 1.0)
    b[B_PARAL] = max(0.0, (target - grid) / target)

    return b
