import numpy as np
import torch

from repro_torch.kernels.matmul.kernel import matmul, matmul_plain
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.matmul.space import (DEFAULT_INPUT, GemmInput,
                                              make_full_space, make_space,
                                              workload_fn)
from repro_torch.kernels.registry import KernelBenchmark, register_benchmark


def _make_args(inp, rng, device):
    """The JAX package's inputs, draw for draw, moved to ``device``."""
    a = rng.standard_normal((inp.m, inp.k), dtype=np.float32)
    b = rng.standard_normal((inp.k, inp.n), dtype=np.float32)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


@register_benchmark("matmul")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.matmul import ops, space

    return KernelBenchmark(
        name="matmul",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={
            "2048": space.DEFAULT_INPUT,
            "128": space.SQUARE_SMALL,
            "16x4096": space.RECT_TALL,
            "4096x16": space.RECT_WIDE,
        },
        make_args=_make_args, run=ops.run, ref=matmul_ref,
    )
