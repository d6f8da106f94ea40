"""The GEMM as the benchmark drives it: its registry entry, its space, its
inputs drawn on the device from the run's seed, and the work its roofline
bound divides (``chip_smoke.py``'s GEMM ``work``, frozen here)."""
from __future__ import annotations

import torch

KERNEL = "matmul"      # the entry of repro_torch.kernels.registry.BENCHMARKS


def make_input(sizes: dict):
    from repro_torch.kernels.matmul.space import GemmInput

    return GemmInput(int(sizes["m"]), int(sizes["n"]), int(sizes["k"]))


def make_space(bench, inp):
    """The reduced (CLBlast-like) space, pruned for the input as the
    registry prunes it."""
    from repro_torch.kernels.matmul.space import make_space

    return make_space(inp)


def make_args(inp, generator: torch.Generator, device) -> tuple:
    """A (m x k) and B (k x n), standard normal float32."""
    return tuple(torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
                 for shape in ((inp.m, inp.k), (inp.k, inp.n)))


def work(inp) -> tuple:
    """(bytes, fp32 operations, rsqrt or exp, operations of products that
    can run by 3xTF32)."""
    products = 2.0 * inp.m * inp.n * inp.k
    return (4.0 * (inp.m * inp.k + inp.k * inp.n + inp.m * inp.n),
            products, 0.0, products)
