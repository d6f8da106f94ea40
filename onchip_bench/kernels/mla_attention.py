"""DeepSeek-V2's latent-attention (MLA) prefill as the benchmark drives it:
the attention kernel's registry entry with q and k at the qk head dim
(nope 128 + rope 64 = 192) and V at its own (128), its space, the inputs
drawn on the device from the run's seed, and the work its roofline bound
divides, frozen here.  At a V head dim equal to the qk dim ``work`` is
``kernels/attention.py``'s."""
from __future__ import annotations

import torch

from yardstick import attention_pairs

KERNEL = "attention"   # the entry of repro_torch.kernels.registry.BENCHMARKS
SCALE = 0.3            # the registry's q, k and v: 0.3 x standard normal


def make_input(sizes: dict):
    """The input of ``sizes``; V's head dim, where ``sizes`` gives none, is
    the qk dim (the attention cells' inputs)."""
    from repro_torch.kernels.attention.space import AttentionInput

    if not sizes["causal"]:
        raise ValueError("the registry's entry runs causal attention only")
    return AttentionInput(int(sizes["batch"]), int(sizes["heads"]),
                          int(sizes["seq"]), int(sizes["head_dim"]),
                          causal=bool(sizes["causal"]),
                          v_head_dim=int(sizes.get("v_head_dim",
                                                   sizes["head_dim"])))


def make_space(bench, inp):
    return bench.make_space()


def make_args(inp, generator: torch.Generator, device) -> tuple:
    """q and k of shape (B, H, S, Dqk) and v of (B, H, S, Dv), float32."""
    qk = (inp.batch, inp.heads, inp.seq, inp.head_dim)
    v = qk[:3] + (inp.v_head_dim,)
    return tuple(SCALE * torch.randn(shape, generator=generator,
                                     device=device, dtype=torch.float32)
                 for shape in (qk, qk, v))


def work(inp) -> tuple:
    """(bytes, fp32 operations, exp, operations of products): q and k read
    at Dqk, v read and the output written at Dv, 4 bytes each; QKᵀ 2·Dqk
    and PV 2·Dv operations a (query, key) pair, one exp a pair."""
    dqk, dv = inp.head_dim, inp.v_head_dim
    pairs = attention_pairs(inp.batch, inp.heads, inp.seq, inp.causal)
    products = 2.0 * (dqk + dv) * pairs
    return (4.0 * inp.batch * inp.heads * inp.seq * (2 * dqk + 2 * dv),
            products, pairs, products)
