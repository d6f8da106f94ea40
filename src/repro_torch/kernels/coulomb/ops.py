"""Tuning-config dict -> Coulomb kernel invocation.  The grid size travels
in the arguments (``make_args`` puts it there), so that an evaluator can
call ``run(cfg, *args)`` like any other kernel's."""
from repro_torch.kernels.coulomb.kernel import coulomb


def run(cfg, atoms, grid_size):
    return coulomb(atoms, grid_size, z_it=cfg["Z_IT"], by=cfg["BY"],
                   bx=cfg["BX"], atom_chunk=cfg["ATOM_CHUNK"],
                   atoms_in_smem=cfg["ATOMS_IN_SMEM"])
