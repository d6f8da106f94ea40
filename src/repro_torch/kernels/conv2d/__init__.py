import numpy as np
import torch

from repro_torch.kernels.conv2d.kernel import conv2d, conv2d_plain
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.conv2d.space import (DEFAULT_INPUT, ConvInput,
                                              make_space, workload_fn)
from repro_torch.kernels.registry import KernelBenchmark, register_benchmark


def _make_args(inp, rng, device):
    """The JAX package's inputs, draw for draw, moved to ``device``."""
    img = rng.standard_normal((inp.h, inp.w), dtype=np.float32)
    flt = rng.standard_normal((inp.f, inp.f), dtype=np.float32)
    return (torch.from_numpy(img).to(device), torch.from_numpy(flt).to(device))


@register_benchmark("conv2d")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.conv2d import ops, space

    return KernelBenchmark(
        name="conv2d",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={"4096": space.DEFAULT_INPUT},
        make_args=_make_args, run=ops.run, ref=conv2d_ref,
    )
