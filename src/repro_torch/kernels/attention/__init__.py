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
    """The JAX package's q, k and v, draw for draw, moved to ``device``; v
    at ``inp.v_head_dim`` where it is set."""
    shape = (inp.batch, inp.heads, inp.seq, inp.head_dim)
    dv = inp.head_dim if inp.v_head_dim is None else inp.v_head_dim

    def mk(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * 0.3).to(device)

    return (mk(shape), mk(shape), mk(shape[:3] + (dv,)))


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
