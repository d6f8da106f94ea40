"""Causal flash attention as the benchmark drives it: its registry entry,
its space, q, k and v drawn on the device from the run's seed, and the work
its roofline bound divides (``chip_smoke.py``'s attention ``work``, frozen
here)."""
from __future__ import annotations

import torch

from yardstick import attention_pairs

KERNEL = "attention"   # the entry of repro_torch.kernels.registry.BENCHMARKS
SCALE = 0.3            # the registry's q, k and v: 0.3 x standard normal


def make_input(sizes: dict):
    from repro_torch.kernels.attention.space import AttentionInput

    if not sizes["causal"]:
        raise ValueError("the registry's entry runs causal attention only")
    return AttentionInput(int(sizes["batch"]), int(sizes["heads"]),
                          int(sizes["seq"]), int(sizes["head_dim"]),
                          causal=bool(sizes["causal"]))


def make_space(bench, inp):
    return bench.make_space()


def make_args(inp, generator: torch.Generator, device) -> tuple:
    """q, k and v of shape (B, H, S, D), float32."""
    shape = (inp.batch, inp.heads, inp.seq, inp.head_dim)
    return tuple(SCALE * torch.randn(shape, generator=generator,
                                     device=device, dtype=torch.float32)
                 for _ in range(3))


def work(inp) -> tuple:
    pairs = attention_pairs(inp.batch, inp.heads, inp.seq, inp.causal)
    return (16.0 * inp.batch * inp.heads * inp.seq * inp.head_dim,
            4.0 * inp.head_dim * pairs, pairs, 4.0 * inp.head_dim * pairs)
