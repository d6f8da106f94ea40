"""N-body tuning space + portable workload model g(TP, I) → PC_ops.

The space and the model are the JAX package's, value for value and formula
for formula, under the Hopper counter names of ``core/counters.py``.  The
model keeps its TPU-shaped terms ((BLOCK_I, BLOCK_J) pairwise tiles on the
(8, 128) register tiling); re-deriving it for the CUDA kernel's four
register-resident bodies a thread and its j-split is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, round_up


@dataclasses.dataclass(frozen=True)
class NBodyInput:
    n: int

    @property
    def tag(self) -> str:
        return f"n{self.n}"


DEFAULT_INPUT = NBodyInput(16384)
LARGE_INPUT = NBodyInput(131072)


def make_space() -> TuningSpace:
    params = [
        TuningParameter("BLOCK_I", (8, 16, 32, 64, 128, 256, 512, 1024)),
        TuningParameter("BLOCK_J", (32, 64, 128, 256, 512, 1024, 2048)),
        TuningParameter("J_UNROLL", (1, 2, 4)),
        # recompute r² vs keep (BI,BJ) temporaries resident (register pressure)
        TuningParameter("KEEP_PAIRWISE", (0, 1)),
    ]
    return TuningSpace(params, name="nbody")


def workload_fn(cfg: Config, inp: NBodyInput = DEFAULT_INPUT) -> Dict[str, float]:
    n = inp.n
    bi, bj = cfg["BLOCK_I"], cfg["BLOCK_J"]
    unroll, keep = cfg["J_UNROLL"], cfg["KEEP_PAIRWISE"]
    ni, nj = cdiv(n, bi), cdiv(n, bj)
    pairs = (ni * bi) * (nj * bj)  # padded pairwise interactions

    # ~14/17 ops per pair (displacements, r², 3 MACs per axis) + 1 rsqrt;
    # the j loop costs control ops unless unrolled
    int_ops = pairs * (14.0 if keep else 17.0) + pairs * 3.0 / max(unroll, 1)
    sfu = pairs * 1.0
    # body tiles: i tile read once, j tiles streamed per i block
    dram_rd = (ni * bi * 16.0) + ni * nj * bj * 16.0
    dram_wr = ni * bi * 16.0
    # (BI, BJ) intermediates (dx/dy/dz/r2/s) round-trip on-chip memory
    # between ops unless kept fused; unrolling improves fusion of the
    # streamed variant
    n_tmp = 5.0 if keep else 8.0 * (1.0 + 0.6 / max(unroll, 1))
    smem_rd = pairs * 4.0 * n_tmp
    smem_wr = ni * nj * bi * 16.0 + pairs * 4.0 * n_tmp * 0.5
    ws = (bi * 16.0 + bj * 16.0) * 2.0 + bi * 16.0 \
        + (bi * bj * 4.0 * 4.0 if keep else bi * bj * 4.0) \
        + bi * bj * 4.0 * 0.25 * (unroll - 1)

    # (BI, BJ) pairwise tiles against the (8, 128) register tiling + edges
    tile_eff = (bi / round_up(bi, 8)) * (bj / round_up(bj, 128))
    edge_eff = (n / (ni * bi)) * (n / (nj * bj))

    return {
        C.FP32_FLOPS: 0.0,
        C.INT_OPS: float(int_ops),
        C.SFU_OPS: float(sfu),
        C.INST_ISSUED: float(int_ops + sfu),
        C.DRAM_RD: float(dram_rd),
        C.DRAM_WR: float(dram_wr),
        C.SMEM_RD: float(smem_rd),
        C.SMEM_WR: float(smem_wr),
        C.CONST_RD: 0.0,
        C.CTAS: float(ni),
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: tile_eff * edge_eff,
    }
