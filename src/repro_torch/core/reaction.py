"""Expert system, part 2: bottlenecks → ΔPC_ops (paper §3.5.2, Eq. 15).

Produces the required-change vector ΔPC_ops over PC_ops counters, each in
[-1, 1]: negative = decrease this counter, positive = increase, 0 = no change.

``inst_reaction`` thresholds instruction-related reactions: instructions have
low latency and only become a real bottleneck under high stress (paper sets
0.7 by default, 0.5 when the user declares the problem instruction-bound).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import bottleneck as B
from repro_torch.core import counters as C

INST_REACTION_DEFAULT = 0.7
INST_REACTION_COMPUTE_BOUND = 0.5


def _inst_delta(b_val: float, inst_reaction: float) -> float:
    """Eq. 15: thresholded reaction to an instruction bottleneck."""
    if b_val <= inst_reaction:
        return 0.0
    return -(b_val - inst_reaction) / (1.0 - inst_reaction)


def compute_delta_pc(
    b: Dict[str, float], inst_reaction: float = INST_REACTION_DEFAULT
) -> Dict[str, float]:
    """Map the bottleneck vector to required PC_ops changes.

    Memory-subsystem reactions are the inverted bottleneck values
    (straightforward per §3.5.2); instruction reactions are thresholded
    (Eq. 15); parallelism reactions are positive (more blocks wanted).
    The paper emits Δpc_SM_E and Δpc_global(threads); both map to the CTAS
    counter, which the workload model knows exactly.
    """
    delta: Dict[str, float] = {k: 0.0 for k in C.PC_OPS}

    # memory subsystems — straight inversion
    delta[C.DRAM_RD] = -b[B.B_DRAM_READ]
    delta[C.DRAM_WR] = -b[B.B_DRAM_WRITE]
    delta[C.SMEM_RD] = -b[B.B_SMEM_READ]
    delta[C.SMEM_WR] = -b[B.B_SMEM_WRITE]
    delta[C.CONST_RD] = -b[B.B_CONST]
    delta[C.LOCAL_B] = -b[B.B_LOCAL]
    # spilling is caused by a block's working set: also push SMEM_WS down
    delta[C.SMEM_WS] = -b[B.B_LOCAL]
    delta[C.NVLINK_B] = -b[B.B_NVLINK]

    # instruction-related — thresholded (Eq. 15)
    delta[C.FP32_FLOPS] = _inst_delta(b[B.B_FP32], inst_reaction)
    delta[C.INT_OPS] = _inst_delta(b[B.B_INT], inst_reaction)
    delta[C.SFU_OPS] = _inst_delta(b[B.B_SFU], inst_reaction)
    delta[C.INST_ISSUED] = _inst_delta(b[B.B_ISSUE], inst_reaction)

    # parallelism — positive reaction (paper: Δpc_SM_E = b_sm, Δpc_global =
    # b_paral); CTAS absorbs both, saturating at 1.
    delta[C.CTAS] = min(1.0, b[B.B_SM] + b[B.B_PARAL])

    return delta
