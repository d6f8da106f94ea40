"""Oracle for the N-body acceleration kernel: all pairs at once, as the JAX
oracle computes them ((N, N, 3) intermediates: small N only).

Used by tests and checks only; the port's path never calls it."""
import torch


def nbody_ref(bodies: torch.Tensor, *, softening: float = 1e-3) -> torch.Tensor:
    pos, mass = bodies[:, :3], bodies[:, 3]
    d = pos[None, :, :] - pos[:, None, :]            # (N, N, 3)
    r2 = (d * d).sum(-1) + softening                 # (N, N)
    inv_r = torch.rsqrt(r2)
    s = mass[None, :] * inv_r * inv_r * inv_r
    acc = (s[:, :, None] * d).sum(1)                 # (N, 3)
    return torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
