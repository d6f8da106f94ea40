"""Convolution tuning space + portable workload model g(TP, I) → PC_ops.

The space and the model are the JAX package's, value for value and formula
for formula, under the Hopper counter names of ``core/counters.py``.  On the
TPU "SMEM" is scalar memory; FILTER_SMEM=1 therefore prices the filter in
the constant cache (``CONST_RD``) and FILTER_SMEM=0 prices it read from
device memory by each block (``DRAM_RD``), which is what the CUDA kernel
does.  The model keeps its TPU-shaped terms (whole halo tiles as DMA
traffic, the (8, 128) register tiling); re-deriving it for the CUDA
kernel's 32 x 128 sub-tiles, 8 x 4 register blocks and halo ring is queued
in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, round_up


@dataclasses.dataclass(frozen=True)
class ConvInput:
    h: int
    w: int
    f: int = 5

    @property
    def tag(self) -> str:
        return f"{self.h}x{self.w}_f{self.f}"


DEFAULT_INPUT = ConvInput(4096, 4096)


def make_space() -> TuningSpace:
    params = [
        TuningParameter("BY", (8, 16, 32, 64, 128, 256, 512)),
        TuningParameter("BX", (128, 256, 512, 1024)),
        TuningParameter("UNROLL_TAPS", (0, 1)),
        # filter placement: device memory vs the constant cache
        TuningParameter("FILTER_SMEM", (0, 1)),
        TuningParameter("DMA_DEPTH", (1, 2, 4)),
    ]
    return TuningSpace(params, name="conv2d")


def workload_fn(cfg: Config, inp: ConvInput = DEFAULT_INPUT) -> Dict[str, float]:
    h, w, f = inp.h, inp.w, inp.f
    by, bx = cfg["BY"], cfg["BX"]
    unroll, fsmem, depth = cfg["UNROLL_TAPS"], cfg["FILTER_SMEM"], cfg["DMA_DEPTH"]
    ny, nx = cdiv(h, by), cdiv(w, bx)
    progs = ny * nx
    halo = f - 1
    pts = progs * by * bx

    # halo tiles re-read the overlap region: bytes copied per block
    tile_bytes = (by + halo) * (bx + halo) * 4.0
    dram_rd = progs * tile_bytes + (0.0 if fsmem else progs * f * f * 4.0)
    const_rd = progs * f * f * 4.0 * by if fsmem else 0.0  # broadcast per row
    dram_wr = pts * 4.0
    int_ops = pts * f * f * 2.0
    if not unroll:
        int_ops += pts * f * f * 0.5  # loop-control overhead on the tap loop
    smem_rd = pts * f * f * 4.0 + progs * tile_bytes
    smem_wr = pts * 4.0
    ws = tile_bytes * depth + by * bx * 4.0 * 2.0 + f * f * 4.0

    tile_eff = (by / round_up(by, 8)) * (bx / round_up(bx, 128))
    edge_eff = (h / (ny * by)) * (w / (nx * bx))

    return {
        C.FP32_FLOPS: 0.0,
        C.INT_OPS: float(int_ops),
        C.SFU_OPS: 0.0,
        C.INST_ISSUED: float(int_ops),
        C.DRAM_RD: float(dram_rd),
        C.DRAM_WR: float(dram_wr),
        C.SMEM_RD: float(smem_rd),
        C.SMEM_WR: float(smem_wr),
        C.CONST_RD: float(const_rd),
        C.CTAS: float(progs),
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: tile_eff * edge_eff,
    }
