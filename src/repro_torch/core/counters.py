"""Hopper performance-counter taxonomy (paper §3.1, Table 1).

The paper splits NVIDIA counters into ``PC_ops`` (operation counts; the
TP→PC_ops relation is portable across hardware and inputs, Eqs. 3–5) and
``PC_stress`` (subsystem utilizations; hardware/input dependent, measured
live).  The names below are the paper's CUDA counters.

Each tuple keeps the order of the JAX package's TPU taxonomy position by
position, and ``TPU_NAMES`` maps every Hopper name onto its TPU counterpart,
so a model, a record or a searcher trace of one package can be held against
the other's (``repro_torch.tuning.serialize.from_jax_artifact``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --- PC_ops: hardware/input-portable operation counts -------------------------
# (each with the CUDA profiler metric it stands for)
DRAM_RD = "DRAM_RD"          # device-memory bytes read: dram_read_transactions
DRAM_WR = "DRAM_WR"          # device-memory bytes written: dram_write_...
SMEM_RD = "SMEM_RD"          # shared-memory load bytes: shared_load_...
SMEM_WR = "SMEM_WR"          # shared-memory store bytes: shared_store_...
CONST_RD = "CONST_RD"        # constant/texture reads: tex_cache_transactions
LOCAL_B = "LOCAL_B"          # spill bytes: local_memory_overhead
FP32_FLOPS = "FP32_FLOPS"    # fp32 operations: inst_fp_32
INT_OPS = "INT_OPS"          # integer / bookkeeping ops: inst_integer
SFU_OPS = "SFU_OPS"          # special functions (exp, rsqrt)
INST_ISSUED = "INST_ISSUED"  # issued instructions: inst_executed
CTAS = "CTAS"                # thread blocks launched (grid size)
NVLINK_B = "NVLINK_B"        # bytes crossing NVLink to other cards
SMEM_WS = "SMEM_WS"          # one block's working set (occupancy input)

PC_OPS = (
    DRAM_RD, DRAM_WR, SMEM_RD, SMEM_WR, CONST_RD, LOCAL_B,
    FP32_FLOPS, INT_OPS, SFU_OPS, INST_ISSUED, CTAS, NVLINK_B, SMEM_WS,
)

# --- PC_stress: live utilizations in [0, 1] -----------------------------------
DRAM_U = "DRAM_U"            # dram_utilization
SMEM_U = "SMEM_U"            # shared_utilization
CONST_U = "CONST_U"          # tex_utilization
NVLINK_U = "NVLINK_U"        # nvlink utilization
FP32_U = "FP32_U"            # single_precision_fu_utilization
INT_U = "INT_U"              # integer function-unit utilization
SFU_U = "SFU_U"              # special_fu_utilization
ISSUE_U = "ISSUE_U"          # issue_slot_utilization
SM_E = "SM_E"                # sm_efficiency
WARP_E = "WARP_E"            # warp_execution_efficiency
OCCUPANCY = "OCCUPANCY"      # achieved_occupancy (working set / capacity)

PC_STRESS = (
    DRAM_U, SMEM_U, CONST_U, NVLINK_U, FP32_U, INT_U, SFU_U, ISSUE_U,
    SM_E, WARP_E, OCCUPANCY,
)

ALL_COUNTERS = PC_OPS + PC_STRESS

# Workload models pass the useful-lane fraction to the cost model under this
# key; it is a model input, not a counter.
WARP_E_HINT = "WARP_E_HINT"

# Hopper name -> the JAX package's TPU name, position by position.
TPU_NAMES: Dict[str, str] = dict(zip(
    ALL_COUNTERS + (WARP_E_HINT,),
    ("HBM_RD", "HBM_WR", "VMEM_RD", "VMEM_WR", "CMEM_RD", "SPILL_B",
     "MXU_FLOPS", "VPU_OPS", "TRANS_OPS", "ISSUE_OPS", "GRID", "ICI_B",
     "VMEM_WS",
     "HBM_U", "VMEM_U", "CMEM_U", "ICI_U", "MXU_U", "VPU_U", "TRANS_U",
     "ISSUE_U", "CORE_E", "LANE_E", "VMEM_OCC",
     "LANE_E_HINT")))
FROM_TPU_NAMES: Dict[str, str] = {v: k for k, v in TPU_NAMES.items()}


@dataclasses.dataclass
class CounterSet:
    """One profiled sample: ops counts + stress utilizations + runtime."""

    ops: Dict[str, float]
    stress: Dict[str, float]
    runtime: float  # seconds

    def __post_init__(self):
        for k in self.ops:
            if k not in PC_OPS:
                raise KeyError(f"unknown PC_ops counter {k!r}")
        for k in self.stress:
            if k not in PC_STRESS:
                raise KeyError(f"unknown PC_stress counter {k!r}")

    def op(self, name: str, default: float = 0.0) -> float:
        return float(self.ops.get(name, default))

    def st(self, name: str, default: float = 0.0) -> float:
        return float(self.stress.get(name, default))
