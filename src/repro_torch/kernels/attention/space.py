"""Flash-attention tuning space + portable workload model g(TP, I) → PC_ops.

The space and the model are the JAX package's, value for value and formula
for formula, under the Hopper counter names of ``core/counters.py``.  The
model keeps its TPU-shaped terms ((8, 128) register tiling of the
(BLOCK_Q, BLOCK_K) score tile, whole BLOCK tiles as the working set) and
prices 2-byte elements (``AttentionInput.dtype_bytes = 2``) although the
registry runs fp32; both are carried as they are (ROADMAP.md, queue 3).

``AttentionInput.v_head_dim`` is the port's own: V's head dim where it is
not q's (DeepSeek-V2's latent attention, 192 and 128).  Set, the model
prices the PV product, V's reads, the output's writes and the working set
at it; unset (None), the input, its tag and every number of the model are
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, round_up


@dataclasses.dataclass(frozen=True)
class AttentionInput:
    batch: int
    heads: int
    seq: int
    head_dim: int
    causal: bool = True
    dtype_bytes: int = 2
    v_head_dim: Optional[int] = None     # None: head_dim

    @property
    def tag(self) -> str:
        tag = f"b{self.batch}h{self.heads}s{self.seq}d{self.head_dim}"
        return tag if self.v_head_dim is None else f"{tag}v{self.v_head_dim}"


DEFAULT_INPUT = AttentionInput(4, 16, 4096, 128)


def make_space() -> TuningSpace:
    params = [
        TuningParameter("BLOCK_Q", (128, 256, 512, 1024)),
        TuningParameter("BLOCK_K", (128, 256, 512, 1024)),
        # keep p=exp(s) resident vs recompute on the PV matmul
        TuningParameter("KEEP_P", (0, 1)),
        TuningParameter("Q_PREFETCH", (1, 2)),
    ]
    return TuningSpace(params, name="attention")


def workload_fn(cfg: Config, inp: AttentionInput = DEFAULT_INPUT) -> Dict[str, float]:
    b, h, s, d, db = inp.batch, inp.heads, inp.seq, inp.head_dim, inp.dtype_bytes
    dv = d if inp.v_head_dim is None else inp.v_head_dim
    bq, bk = cfg["BLOCK_Q"], cfg["BLOCK_K"]
    keep_p, depth = cfg["KEEP_P"], cfg["Q_PREFETCH"]
    nq, nk = cdiv(s, bq), cdiv(s, bk)
    heads = b * h
    causal_f = 0.5 if inp.causal else 1.0

    visited = heads * nq * nk * causal_f + heads * nq * 0.5  # diagonal blocks
    flops = visited * (2.0 * bq * bk) * (d + dv)             # QK^T + PV
    trans = visited * bq * bk                                 # exp
    vpu = visited * bq * bk * 6.0                             # max/sum/scale
    hbm_rd = heads * (s * d * db
                      + nq * (nk * causal_f + 0.5) * bk * (d + dv) * db)
    hbm_wr = heads * s * dv * db
    vmem_rd = visited * (bq * d + bk * (d + dv)
                         + bq * bk * (2 if keep_p else 3)) * db
    vmem_wr = visited * (bq * bk + bq * dv) * 4.0
    ws = (bq * d * db * depth + bk * (d + dv) * db * 2
          + bq * dv * 4.0 + (bq * bk * 4.0 if keep_p else 0.0) + bq * 8.0)

    tile_eff = (bq / round_up(bq, 8)) * (bk / round_up(bk, 128))
    edge_eff = (s / (nq * bq)) * (s / (nk * bk))

    return {
        C.FP32_FLOPS: float(flops),
        C.INT_OPS: float(vpu),
        C.SFU_OPS: float(trans),
        C.INST_ISSUED: float(flops + vpu + trans),
        C.DRAM_RD: float(hbm_rd),
        C.DRAM_WR: float(hbm_wr),
        C.SMEM_RD: float(vmem_rd),
        C.SMEM_WR: float(vmem_wr),
        C.CONST_RD: 0.0,
        C.CTAS: float(heads * nq),
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: tile_eff * edge_eff,
    }
