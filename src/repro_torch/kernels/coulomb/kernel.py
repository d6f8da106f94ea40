"""Direct Coulomb summation for Hopper (the paper's running example,
Listing 1): the wrapper, its launch count and its plain PyTorch version.

Replaces the Pallas TPU kernel ``coulomb`` (body ``_coulomb_kernel``) of
``src/repro/kernels/coulomb/kernel.py``: on a gs³ grid of spacing 0.5,
V[z, y, x] = Σ_j w_j · rsqrt(max(|p − a_j|², 1e-12)) with p = (x, y, z) ·
spacing, x along the last axis; atoms are rows (x, y, z, w).

The CUDA kernel is ``repro_torch/csrc/coulomb.cu``; its header says what
bounds it (the special-function unit's rsqrt) and how a block of 32 x 8
threads walks its (Z_IT, BY, BX) block.  Z_IT is per-thread z coarsening
(a template: dx² + dy² computed once per atom for Z_IT points); BY and BX
set the block; ATOMS_IN_SMEM=1 reads the atoms from ``__constant__`` memory
(on the TPU "SMEM" is scalar memory, the constant cache's counterpart),
0 streams them from device memory through shared memory in ATOM_CHUNK
tiles with the tail zeroed.  Constant memory holds 4096 atoms (64 KB);
with more, the entry copies and launches once per 4096 atoms, each launch
adding to the output — still one counted launch of the wrapper.  ATOM_CHUNK is priced only when the atoms sit in constant memory.

``coulomb`` launches the kernel for CUDA tensors and raises when the build
or the launch fails; it takes ``coulomb_plain`` only for tensors on the
CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import entry, launch

SOURCE = "coulomb.cu"
Z_ITS = (1, 2, 4, 8, 16, 32, 64)   # compiled z-coarsening factors
MAX_CHUNK = 2048                    # shared-memory atom tile: 32 KB
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
_INT_MAX = 2**31 - 1


@functools.cache
def _entry():
    return entry(SOURCE, "repro_coulomb_f32", _ARGTYPES)


def _check(atoms: torch.Tensor, grid_size: int, z_it: int, by: int, bx: int,
           atom_chunk: int, atoms_in_smem: int) -> None:
    if atoms.dtype != torch.float32:
        raise TypeError(f"coulomb takes float32 atoms, got {atoms.dtype}")
    if atoms.dim() != 2 or atoms.shape[1] != 4:
        raise ValueError(f"coulomb takes (n_atoms, 4) atoms, got "
                         f"{tuple(atoms.shape)}")
    if not atoms.is_contiguous():
        raise ValueError("coulomb takes contiguous atoms")
    if grid_size < 1:
        raise ValueError(f"grid_size must be positive, got {grid_size}")
    if z_it not in Z_ITS:
        raise ValueError(f"z_it must be one of {Z_ITS}, got {z_it}")
    if min(by, bx) < 1 or not 1 <= atom_chunk <= MAX_CHUNK:
        raise ValueError(f"need positive blocks and 1 <= atom_chunk <= "
                         f"{MAX_CHUNK}, got {(by, bx, atom_chunk)}")
    if atoms_in_smem not in (0, 1):
        raise ValueError(f"atoms_in_smem must be 0 or 1, got "
                         f"{atoms_in_smem!r}")
    if atoms.shape[0] > _INT_MAX:
        raise ValueError("coulomb takes fewer than 2**31 atoms")


def coulomb_plain(atoms: torch.Tensor, grid_size: int, *,
                  spacing: float = 0.5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: one pass over the grid per
    atom, as the JAX oracle scans."""
    gs = grid_size
    axis = torch.arange(gs, dtype=torch.float32, device=atoms.device) * spacing
    fz, fy, fx = torch.meshgrid(axis, axis, axis, indexing="ij")
    out = torch.zeros((gs, gs, gs), dtype=torch.float32, device=atoms.device)
    for ax, ay, az, w in atoms:
        dx, dy, dz = fx - ax, fy - ay, fz - az
        r2 = dx * dx + dy * dy + dz * dz
        out += w * torch.rsqrt(torch.clamp(r2, min=1e-12))
    return out


def coulomb(atoms: torch.Tensor, grid_size: int, *, z_it: int = 4,
            by: int = 8, bx: int = 128, atom_chunk: int = 32,
            atoms_in_smem: int = 0, spacing: float = 0.5) -> torch.Tensor:
    """The (gs, gs, gs) potential of ``atoms`` (fp32), with the parameters
    of the Coulomb space."""
    _check(atoms, grid_size, z_it, by, bx, atom_chunk, atoms_in_smem)
    if atoms.device.type == "cpu":
        return coulomb_plain(atoms, grid_size, spacing=spacing)
    if atoms.device.type != "cuda":
        raise ValueError(f"coulomb runs on CUDA or the CPU, not "
                         f"{atoms.device}")
    if atoms.data_ptr() % 16:
        raise ValueError("coulomb reads atoms as float4: their storage must "
                         "be 16-byte aligned")
    gs = grid_size
    out = torch.empty((gs, gs, gs), dtype=torch.float32, device=atoms.device)
    if atoms.shape[0] == 0:
        return out.zero_()
    rc = launch(_entry(), atoms.device, atoms.data_ptr(), out.data_ptr(), gs,
                atoms.shape[0], z_it, by, bx, atom_chunk, atoms_in_smem,
                spacing)
    if rc != 0:
        raise RuntimeError(f"coulomb kernel launch failed: CUDA error {rc} "
                           f"at grid {gs}, {atoms.shape[0]} atoms with "
                           f"z_it={z_it}, blocks {(by, bx)}, "
                           f"atom_chunk={atom_chunk}, "
                           f"atoms_in_smem={atoms_in_smem}")
    coulomb.launches += 1
    return out


coulomb.launches = 0
