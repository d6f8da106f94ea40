"""AdamW and its schedules, in PyTorch: the JAX package's
``repro.optim.adamw`` carried over.

A tree here is a dict of tensors keyed by name (a module's
``dict(named_parameters())``).  The state is fp32 and mirrors the
parameters leaf for leaf.  The rounding order is the JAX package's: the
moments in fp32, the update computed in fp32 and cast to the parameter's
dtype, then added in that dtype.  The moments and the parameters are
updated in place, under ``torch.no_grad()``; the step count stays an
int32 tensor, so that a schedule reads it as the JAX one does.

Under the sharded step the leaves are ``DTensor`` tensors (the moments laid
out as their parameters): the per-leaf update runs on each rank's local
shards, element for element as on one device, and the global norm of
``clip_by_global_norm`` covers the full tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    @staticmethod
    def init(params: Tree) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}

        device = next(iter(params.values())).device
        return AdamWState(m=zeros(), v=zeros(),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        """The updates to add to ``params`` (each rank's local shard of a
        ``DTensor`` leaf); ``state``'s moments are advanced in place and
        returned with the count advanced."""
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        lr = self.lr(count)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        updates = {}
        for k, p in params.items():
            p = local(p)
            g = local(grads[k]).float()
            m = local(state.m[k]).mul_(b1).add_(g * (1 - b1))
            v = local(state.v[k]).mul_(b2).add_(torch.square(g) * (1 - b2))
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            step = step + self.weight_decay * p.float()
            updates[k] = (-lr * step).to(p.dtype)
        return updates, AdamWState(m=state.m, v=state.v, count=count)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view), a tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params`` plus ``updates``, each added in place in its dtype (to
    this rank's shard of a ``DTensor`` leaf)."""
    for k, p in params.items():
        local(p).add_(local(updates[k]))
    return params


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return schedule


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)
