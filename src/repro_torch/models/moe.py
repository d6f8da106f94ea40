"""Mixture-of-Experts feed-forward, in PyTorch.

The JAX package's ``repro.models.moe`` carried over: the GShard-style
capacity dispatch (``moe_apply``: routing groups of ``group_size`` tokens,
per-expert capacity buckets, dispatch and combine einsums; the training
and large-prefill path) and the dropless dispatch (``moe_apply_dropless``:
tokens sorted by expert, exact; the serving path).  Shared (always-on)
experts (DeepSeek-V2) and top-1 routing (Llama-4-Scout) are supported.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import index_add_, shard_act
from repro_torch.models.common import (ParamDef, Params, dense, mlp_apply,
                                       mlp_defs)


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # always-active shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    group_size: int = 256     # routing-group tokens (bounds dispatch tensor)


def moe_defs(cfg: MoEConfig) -> Dict[str, ParamDef]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamDef((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.n_shared:
        defs["shared"] = mlp_defs(d, f * cfg.n_shared, gated=True)
    return defs


def _route(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """Router probabilities and the renormalized top-k gates."""
    probs = torch.softmax(dense(x, p["router"]).float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def moe_apply(p: Params, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss); capacity-bucket dispatch."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    tg = min(cfg.group_size, t)
    assert t % tg == 0, (t, tg)
    g = t // tg
    xg = x.reshape(g, tg, d)

    probs, gate_vals, gate_idx = _route(p, cfg, xg)          # (G, Tg, k)

    # load-balancing auxiliary loss (Switch-style), over all tokens
    me = torch.mean(probs, dim=(0, 1))                        # (E,)
    ce = torch.mean(F.one_hot(gate_idx[..., 0], e).float(), dim=(0, 1))
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    capacity = int(cfg.capacity_factor * tg * k / e) + 1

    # bucket position of each (token, choice) within its expert, per group
    onehot = F.one_hot(gate_idx, e)                           # (G, Tg, k, E)
    flat = onehot.reshape(g, tg * k, e)
    pos = torch.cumsum(flat, dim=1) - 1                       # (G, Tg*k, E)
    pos = torch.sum(pos * flat, dim=-1).reshape(g, tg, k)
    keep = pos < capacity

    # combine tensor: (G, Tg, E, C) = Σ_k gate · onehot(expert) ⊗ onehot(pos)
    # (a bucket position past the capacity has no column: its token drops)
    pos_oh = F.one_hot(torch.clamp(pos, max=capacity), capacity + 1)
    combine = torch.einsum(
        "gtke,gtkc->gtec",
        (gate_vals * keep).to(x.dtype)[..., None]
        * F.one_hot(gate_idx, e).to(x.dtype),
        pos_oh[..., :capacity].to(x.dtype),
    )
    dispatch = (combine > 0).to(x.dtype)

    # expert inputs: (E, G, C, D)
    xin = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"])) \
        * torch.einsum("egcd,edf->egcf", xin, p["w_up"])
    yout = torch.einsum("egcf,efd->egcd", h, p["w_down"])     # (E, G, C, D)

    yg = combine_experts(combine, yout)

    out = yg.reshape(b, s, d)
    if cfg.n_shared:
        out = out + mlp_apply(p["shared"], x)
    return out, aux


def combine_experts(combine: torch.Tensor, yout: torch.Tensor
                    ) -> torch.Tensor:
    """``einsum("gtec,egcd->gtd", combine, yout)`` as one batched product
    over the (expert, slot) pairs taken expert-major: torch 2.11's DTensor
    flattens a split dim only where it leads the flattened dims, and the
    expert dim is the split one (the einsum takes it second)."""
    g, tg, e, c = combine.shape
    d = yout.shape[-1]
    return torch.bmm(combine.reshape(g, tg, e * c),
                     yout.permute(1, 0, 2, 3).reshape(g, e * c, d))


def group_sizes(flat_expert: torch.Tensor, e: int):
    """The tokens routed to each of the ``e`` experts, read on the host.
    The dry run, whose fake tensors hold no routing, puts its own
    assumption here while it counts (``launch.dryrun.expected_loads``)."""
    return torch.bincount(flat_expert, minlength=e).tolist()


def moe_apply_dropless(p: Params, cfg: MoEConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """Inference dispatch: exact, dropless, sorted by expert.

    Where the JAX package calls ``jax.lax.ragged_dot`` (a grouped GEMM
    outside any Pallas kernel), the port takes one ``torch.matmul`` for
    each expert that has tokens; the group sizes are read on the host.
    Under a mesh every rank routes every token (the tokens made whole
    first): DTensor has no rule for the sort's segments."""
    x = shard_act(x, (None, None, None))
    b, sq, d = x.shape
    t = b * sq
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)

    _, gate_vals, gate_idx = _route(p, cfg, xt)               # (T, k)

    flat_expert = gate_idx.reshape(-1)                        # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    tok_of = order // k                                       # source token
    xs = xt[tok_of]                                           # (T*k, D)
    sizes = group_sizes(flat_expert, e)

    ys = torch.empty_like(xs)
    start = 0
    for ex, n in enumerate(sizes):
        if n:
            seg = xs[start:start + n]
            h = F.silu(seg @ p["w_gate"][ex]) * (seg @ p["w_up"][ex])
            ys[start:start + n] = h @ p["w_down"][ex]
            start += n

    gv = gate_vals.reshape(-1)[order]                         # (T*k,)
    out = index_add_(torch.zeros_like(xt, dtype=ys.dtype), 0, tok_of,
                     ys * gv[:, None].to(ys.dtype))
    out = out.reshape(b, sq, d).to(x.dtype)
    if cfg.n_shared:
        out = out + mlp_apply(p["shared"], x)
    return out
