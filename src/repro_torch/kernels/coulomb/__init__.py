import numpy as np
import torch

from repro_torch.kernels.coulomb.kernel import coulomb, coulomb_plain
from repro_torch.kernels.coulomb.ref import coulomb_ref
from repro_torch.kernels.coulomb.space import (DEFAULT_INPUT, CoulombInput,
                                               make_space, workload_fn)
from repro_torch.kernels.registry import KernelBenchmark, register_benchmark


def _make_args(inp, rng, device):
    """The JAX package's atoms, draw for draw, moved to ``device``, and the
    grid size, which the JAX package passes to ``run`` as a keyword."""
    atoms = rng.uniform(0.0, inp.grid_size * 0.5,
                        (inp.n_atoms, 4)).astype(np.float32)
    atoms[:, 3] = rng.uniform(0.1, 1.0, inp.n_atoms)
    return (torch.from_numpy(atoms).to(device), inp.grid_size)


@register_benchmark("coulomb")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.coulomb import ops, space

    return KernelBenchmark(
        name="coulomb",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={
            "default": space.DEFAULT_INPUT,
            "large_grid": space.LARGE_GRID,
            "small_grid": space.SMALL_GRID,
        },
        make_args=_make_args, run=ops.run, ref=coulomb_ref,
    )
