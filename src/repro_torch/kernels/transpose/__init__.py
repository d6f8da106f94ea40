import numpy as np
import torch

from repro_torch.kernels.registry import KernelBenchmark, register_benchmark
from repro_torch.kernels.transpose.kernel import transpose, transpose_plain
from repro_torch.kernels.transpose.ref import transpose_ref
from repro_torch.kernels.transpose.space import (DEFAULT_INPUT, TransposeInput,
                                                 make_space, workload_fn)


def _make_args(inp, rng, device):
    """The JAX package's input, draw for draw, moved to ``device``."""
    x = rng.standard_normal((inp.m, inp.n), dtype=np.float32)
    return (torch.from_numpy(x).to(device),)


@register_benchmark("transpose")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.transpose import ops, space

    return KernelBenchmark(
        name="transpose",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={"8192": space.DEFAULT_INPUT},
        make_args=_make_args, run=ops.run, ref=transpose_ref,
    )
