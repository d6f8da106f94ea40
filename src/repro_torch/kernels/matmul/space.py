"""GEMM tuning space + portable workload model g(TP, I) → PC_ops.

The spaces are the JAX package's, value for value, so that a model, a record
or a search of one package can be held against the other's.  Space
character follows CLBlast's reduced GEMM space (paper Table 2).
``make_full_space`` is the CLTune-like larger space (GEMM-full analog) used
for the small-space-model → big-space-search experiment (§4.6.2 / Fig. 8).

The workload model is carried over formula for formula, terms shaped by the
TPU included: ``lane_efficiency_2d``'s (8, 128) padding and a working set of
whole BLOCK tiles.  The CUDA kernel stages 64 x 64 sub-tiles in 32-deep
chunks instead; re-deriving the model for that staging is queued in
ROADMAP.md with the kernel's redesign.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, lane_efficiency_2d, round_up


@dataclasses.dataclass(frozen=True)
class GemmInput:
    m: int
    n: int
    k: int
    dtype_bytes: int = 4

    @property
    def tag(self) -> str:
        return f"{self.m}x{self.n}x{self.k}"


DEFAULT_INPUT = GemmInput(2048, 2048, 2048)
SQUARE_SMALL = GemmInput(128, 128, 128)
RECT_TALL = GemmInput(16, 4096, 4096)     # 16 x 4096 (memory bound)
RECT_WIDE = GemmInput(4096, 16, 4096)     # 4096 x 16 (memory bound)


def make_space(inp: "GemmInput" = None) -> TuningSpace:
    """Reduced (CLBlast-like) GEMM space.

    ``inp`` enables the expert input-aware pruning the paper's spaces have
    (§4.2: no obviously-absurd configurations — e.g. tiles several times
    larger than the matrix, the sub-warp-block analog).
    """
    params = [
        TuningParameter("BLOCK_M", (64, 128, 256, 512)),
        TuningParameter("BLOCK_N", (64, 128, 256, 512)),
        TuningParameter("BLOCK_K", (128, 256, 512, 1024)),
        TuningParameter("LOOP_ORDER", ("mnk", "nmk")),
        TuningParameter("ACC_F32", (0, 1)),
    ]
    # footprint guard: expert-designed spaces exclude absurd configs
    # (paper §4.2 note) but deliberately keep the spill cliff inside.
    def fits_rough(cfg: Config) -> bool:
        ws = _working_set(cfg, dtype_bytes=4)
        return ws <= 512 * 2**20  # drop only absurd configs

    constraints = [fits_rough]
    if inp is not None:
        def not_absurd(cfg: Config) -> bool:
            return (cfg["BLOCK_M"] <= max(64, 2 * inp.m)
                    and cfg["BLOCK_N"] <= max(64, 2 * inp.n)
                    and cfg["BLOCK_K"] <= max(128, 2 * inp.k))
        constraints.append(not_absurd)

    return TuningSpace(params, constraints=constraints, name="gemm")


def make_full_space() -> TuningSpace:
    """CLTune-like larger space (GEMM-full analog): more dims and values."""
    params = [
        TuningParameter("BLOCK_M", (32, 64, 128, 256, 512)),
        TuningParameter("BLOCK_N", (32, 64, 128, 256, 512)),
        TuningParameter("BLOCK_K", (64, 128, 256, 512, 1024)),
        TuningParameter("LOOP_ORDER", ("mnk", "nmk")),
        TuningParameter("ACC_F32", (0, 1)),
        TuningParameter("OUT_SWIZZLE", (0, 1)),
        TuningParameter("K_UNROLL", (1, 2, 4)),
        TuningParameter("PREFETCH_DEPTH", (1, 2, 3)),
    ]

    def fits_rough(cfg: Config) -> bool:
        return _working_set(cfg, dtype_bytes=4) <= 512 * 2**20

    return TuningSpace(params, constraints=[fits_rough], name="gemm_full")


def _working_set(cfg: Config, dtype_bytes: int) -> float:
    bm, bn, bk = cfg["BLOCK_M"], cfg["BLOCK_N"], cfg["BLOCK_K"]
    acc_bytes = 4 if cfg.get("ACC_F32", 1) else dtype_bytes
    depth = cfg.get("PREFETCH_DEPTH", 1)
    # A tile + B tile (x prefetch depth) + accumulator + out tile
    return (bm * bk + bk * bn) * dtype_bytes * depth + bm * bn * (
        acc_bytes + dtype_bytes
    )


def workload_fn(cfg: Config, inp: GemmInput = DEFAULT_INPUT) -> Dict[str, float]:
    """g: TP × I → PC_ops (hardware-independent operation counts)."""
    m, n, k, db = inp.m, inp.n, inp.k, inp.dtype_bytes
    bm, bn, bk = cfg["BLOCK_M"], cfg["BLOCK_N"], cfg["BLOCK_K"]
    nm, nn, nk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
    unroll = cfg.get("K_UNROLL", 1)
    swizzle = cfg.get("OUT_SWIZZLE", 0)

    # device-memory traffic: A re-read per n-tile, B re-read per m-tile, C
    # written once
    dram_rd = (nm * nn * nk) * (bm * bk + bk * bn) * db
    dram_wr = nm * nn * bm * bn * db
    # flops on padded tiles (padding waste captured by the WARP_E hint too)
    flops = 2.0 * (nm * bm) * (nn * bn) * (nk * bk)
    # on-chip traffic feeding the FMAs + accumulator read-modify-write
    acc_bytes = 4 if cfg.get("ACC_F32", 1) else db
    smem_rd = (nm * nn * nk) * (bm * bk + bk * bn) * db \
        + (nm * nn * nk) * bm * bn * acc_bytes
    smem_wr = (nm * nn * nk) * bm * bn * acc_bytes
    # swizzled store does one extra on-chip pass over the out tile
    if swizzle:
        smem_rd += nm * nn * bm * bn * db
        smem_wr += nm * nn * bm * bn * db
    # unrolling reduces loop-control issue ops, slightly raises SMEM_WS
    int_ops = nm * nn * nk * bm * bn / max(unroll, 1) * 0.05
    ws = _working_set(cfg, db) * (1.0 + 0.08 * (unroll - 1))

    warp_e = lane_efficiency_2d(bm, bn, m, n)
    # k-padding waste also burns fp32 cycles
    warp_e *= k / round_up(k, bk)

    return {
        C.FP32_FLOPS: flops,
        C.INT_OPS: int_ops,
        C.SFU_OPS: 0.0,
        C.INST_ISSUED: flops + int_ops,
        C.DRAM_RD: float(dram_rd),
        C.DRAM_WR: float(dram_wr),
        C.SMEM_RD: float(smem_rd),
        C.SMEM_WR: float(smem_wr),
        C.CONST_RD: 0.0,
        C.CTAS: float(nm * nn),  # k dim is sequential within a block
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: warp_e,
    }
