import numpy as np
import torch

from repro_torch.kernels.attention.kernel import (flash_attention,
                                                  flash_attention_plain)
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.attention.space import (DEFAULT_INPUT,
                                                 AttentionInput, make_space,
                                                 workload_fn)
from repro_torch.kernels.registry import KernelBenchmark, register_benchmark


def _make_args(inp, rng, device):
    """The JAX package's q, k and v, draw for draw, moved to ``device``."""
    shape = (inp.batch, inp.heads, inp.seq, inp.head_dim)

    def mk():
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * 0.3).to(device)

    return (mk(), mk(), mk())


@register_benchmark("attention")
def _benchmark() -> KernelBenchmark:
    from repro_torch.kernels.attention import ops, space

    return KernelBenchmark(
        name="attention",
        make_space=space.make_space,
        workload_fn=space.workload_fn,
        default_input=space.DEFAULT_INPUT,
        inputs={"default": space.DEFAULT_INPUT},
        make_args=_make_args, run=ops.run, ref=attention_ref,
    )
