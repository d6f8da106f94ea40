import numpy as np
import torch

from repro_torch.kernels.nbody.kernel import nbody, nbody_plain
from repro_torch.kernels.nbody.ref import nbody_ref
from repro_torch.kernels.nbody.space import (DEFAULT_INPUT, NBodyInput,
                                             make_space, workload_fn)
from repro_torch.kernels.registry import KernelBenchmark, register_benchmark


def _make_args(inp, rng, device):
    """The JAX package's bodies, draw for draw, moved to ``device``."""
    b = rng.standard_normal((inp.n, 4)).astype(np.float32)
    b[:, 3] = np.abs(b[:, 3]) + 0.1
    return (torch.from_numpy(b).to(device),)


@register_benchmark("nbody")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.nbody import ops, space

    return KernelBenchmark(
        name="nbody",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={
            "16k": space.DEFAULT_INPUT,
            "131k": space.LARGE_INPUT,
        },
        make_args=_make_args, run=ops.run, ref=nbody_ref,
    )
