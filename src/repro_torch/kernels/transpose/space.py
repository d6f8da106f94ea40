"""Transpose tuning space + portable workload model g(TP, I) → PC_ops.

The space and the model are the JAX package's, value for value and formula
for formula, under the Hopper counter names of ``core/counters.py``.  The
model keeps its TPU-shaped terms (the (8, 128) register tiling of both the
read and the write tile); re-deriving it for the CUDA kernel's 32 x 32
staging is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, round_up


@dataclasses.dataclass(frozen=True)
class TransposeInput:
    m: int
    n: int
    dtype_bytes: int = 4

    @property
    def tag(self) -> str:
        return f"{self.m}x{self.n}"


DEFAULT_INPUT = TransposeInput(8192, 8192)


def make_space() -> TuningSpace:
    params = [
        TuningParameter("BLOCK_M", (8, 16, 32, 64, 128, 256, 512, 1024)),
        TuningParameter("BLOCK_N", (8, 16, 32, 64, 128, 256, 512, 1024)),
        # staging the write tile through padded shared memory
        TuningParameter("STAGE_OUT", (0, 1)),
    ]
    return TuningSpace(params, name="transpose")


def workload_fn(cfg: Config,
                inp: TransposeInput = DEFAULT_INPUT) -> Dict[str, float]:
    m, n, db = inp.m, inp.n, inp.dtype_bytes
    bm, bn = cfg["BLOCK_M"], cfg["BLOCK_N"]
    nm, nn = cdiv(m, bm), cdiv(n, bn)
    stage = cfg["STAGE_OUT"]

    dram = nm * nn * bm * bn * db  # padded tiles move padded bytes
    smem = 2.0 * dram + (dram if stage else 0.0)
    # shuffle passes: unaligned tiles cost an extra pass
    shuffle_passes = 1.0
    if bm % 8 or bn % 128:
        shuffle_passes = 2.0
    int_ops = nm * nn * bm * bn * shuffle_passes
    ws = (2.0 + (1.0 if stage else 0.0)) * bm * bn * db

    # both the read tile (bm, bn) and the write tile (bn, bm) against the
    # (8, 128) register tiling
    read_eff = (bm / round_up(bm, 8)) * (bn / round_up(bn, 128))
    write_eff = (bn / round_up(bn, 8)) * (bm / round_up(bm, 128))
    edge_eff = (m / round_up(m, bm)) * (n / round_up(n, bn))
    warp_e = min(read_eff, write_eff) * edge_eff

    return {
        C.FP32_FLOPS: 0.0,
        C.INT_OPS: float(int_ops),
        C.SFU_OPS: 0.0,
        C.INST_ISSUED: float(int_ops),
        C.DRAM_RD: float(dram),
        C.DRAM_WR: float(dram),
        C.SMEM_RD: float(smem),
        C.SMEM_WR: float(smem),
        C.CONST_RD: 0.0,
        C.CTAS: float(nm * nn),
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: warp_e,
    }
