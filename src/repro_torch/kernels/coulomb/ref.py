"""Oracle for Direct Coulomb Summation (paper Eq. 1), written apart from the
kernel's plain version: atoms in chunks of 64, each chunk's contributions
summed over a broadcast (chunk, Z, Y, X) block.

Used by tests and checks only; the port's path never calls it."""
import torch


def coulomb_ref(atoms: torch.Tensor, grid_size: int, *,
                spacing: float = 0.5, chunk: int = 64) -> torch.Tensor:
    gs = grid_size
    axis = torch.arange(gs, dtype=torch.float32, device=atoms.device) * spacing
    fz, fy, fx = torch.meshgrid(axis, axis, axis, indexing="ij")
    out = torch.zeros((gs, gs, gs), dtype=torch.float32, device=atoms.device)
    for a0 in range(0, atoms.shape[0], chunk):
        a = atoms[a0:a0 + chunk, :, None, None, None]
        r2 = (fx - a[:, 0]) ** 2 + (fy - a[:, 1]) ** 2 + (fz - a[:, 2]) ** 2
        out += (a[:, 3] * torch.rsqrt(torch.clamp(r2, min=1e-12))).sum(0)
    return out
