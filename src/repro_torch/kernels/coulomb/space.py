"""Coulomb summation tuning space + portable workload model (paper §2).

The space and the model are the JAX package's, value for value and formula
for formula, under the Hopper counter names of ``core/counters.py``: z
coarsening (the worked example's Z_ITERATIONS), block shape, atom chunking,
and a binary placement of the atom table.  On the TPU "SMEM" is scalar
memory; ATOMS_IN_SMEM=1 therefore prices the atoms in the constant cache
(``CONST_RD``) and 0 prices them streamed from device memory (``DRAM_RD``),
which is what the CUDA kernel does.  Re-deriving the model for the CUDA
kernel is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.kernels.common import cdiv, round_up


@dataclasses.dataclass(frozen=True)
class CoulombInput:
    grid_size: int
    n_atoms: int

    @property
    def tag(self) -> str:
        return f"g{self.grid_size}_a{self.n_atoms}"


DEFAULT_INPUT = CoulombInput(256, 256)
LARGE_GRID = CoulombInput(256, 64)
SMALL_GRID = CoulombInput(32, 4096)


def make_space() -> TuningSpace:
    params = [
        TuningParameter("Z_IT", (1, 2, 4, 8, 16, 32, 64)),
        TuningParameter("BY", (4, 8, 16, 32, 64)),
        TuningParameter("BX", (64, 128, 256, 512, 1024)),
        TuningParameter("ATOM_CHUNK", (4, 16, 64, 256)),
        TuningParameter("ATOMS_IN_SMEM", (0, 1)),
    ]

    def block_fits_grid(cfg: Config) -> bool:
        # expert pruning: z-coarsening cannot exceed typical grid extents
        return cfg["Z_IT"] * cfg["BY"] <= 512

    return TuningSpace(params, constraints=[block_fits_grid], name="coulomb")


def workload_fn(cfg: Config,
                inp: CoulombInput = DEFAULT_INPUT) -> Dict[str, float]:
    gs, na = inp.grid_size, inp.n_atoms
    z, by, bx = cfg["Z_IT"], cfg["BY"], cfg["BX"]
    chunk = cfg["ATOM_CHUNK"]
    smem = cfg["ATOMS_IN_SMEM"]

    nz, ny, nx = cdiv(gs, z), cdiv(gs, by), cdiv(gs, bx)
    progs = nz * ny * nx
    pts_padded = (nz * z) * (ny * by) * (nx * bx)  # padded grid points

    # per point-atom pair: dz/r2 (4 ops) + w*rinv accumulate (2 ops);
    # dx,dy invariant across the z loop — amortized by coarsening (paper §2.2)
    int_ops = pts_padded * na * 6.0 + pts_padded * na * 5.0 / z
    sfu = pts_padded * na * 1.0  # rsqrt
    # atom table re-read once per block per chunk pass
    atom_bytes = progs * round_up(na, chunk) * 16.0
    dram_rd = 0.0 if smem else atom_bytes
    const_rd = atom_bytes if smem else 0.0
    dram_wr = pts_padded * 4.0
    # atom broadcast into the point tile re-reads the atom tile once per
    # z-group (register locality — the paper's texture-cache-traffic analog)
    # + (chunk, Z, BY, BX) intermediates round-tripping on-chip memory
    smem_rd = atom_bytes + pts_padded * na * (8.0 + 16.0 / z)
    smem_wr = pts_padded * 4.0 * cdiv(na, chunk)  # accumulator writeback/chunk

    ws = 2.0 * z * by * bx * 4.0 + chunk * 16.0 + 3.0 * z * by * bx * 4.0

    # (BY, BX) against the (8, 128) register tiling; grid-edge waste
    tile_eff = (by / round_up(by, 8)) * (bx / round_up(bx, 128))
    edge_eff = (gs / (nz * z)) * (gs / (ny * by)) * (gs / (nx * bx))
    warp_e = tile_eff * edge_eff

    return {
        C.FP32_FLOPS: 0.0,
        C.INT_OPS: float(int_ops),
        C.SFU_OPS: float(sfu),
        C.INST_ISSUED: float(int_ops + sfu),
        C.DRAM_RD: float(dram_rd),
        C.DRAM_WR: float(dram_wr),
        C.SMEM_RD: float(smem_rd),
        C.SMEM_WR: float(smem_wr),
        C.CONST_RD: float(const_rd),
        C.CTAS: float(progs),
        C.SMEM_WS: float(ws),
        C.WARP_E_HINT: warp_e,
    }
