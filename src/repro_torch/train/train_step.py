"""The train step, in PyTorch: loss -> gradients (microbatches
accumulated, layers rematerialized) -> optional int8 round trip -> clip ->
AdamW.  The JAX package's ``repro.train.train_step`` carried over.

``TrainState.params`` is the model's ``ParamTree`` with trainable leaves;
the optimizer's trees are dicts keyed by its parameter names.  A step
updates the parameters and the moments in place and returns the state
with the count and the step advanced.  Every parameter must receive a
gradient: ``torch.autograd.grad`` raises for one the loss does not reach
(the kernel's output has none unless it is reached through
``KernelAttention``).

Distribution comes from layouts, as in JAX: ``shard_train_state`` lays
the parameters out on a mesh by their logical axes (``DTensor`` tensors, FSDP
over "data", TP over "model") and the moments as their parameters;
``make_train_step(..., mesh=, rules=)`` runs the loss under the
activation resolver, DTensor reduces each gradient onto its parameter's
layout, the clip's norm covers the full tensors, and AdamW updates each
rank's local shards.  On a one-device mesh nothing is split, as in JAX.
``abstract_train_state`` is the dry run's state: the same tree as meta
tensors, nothing allocated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.api import activation_sharding, shard_act
from repro_torch.distributed.compression import quantize_dequantize_tree
from repro_torch.distributed.sharding import (ShardingRules,
                                              make_act_resolver,
                                              shard_params)
from repro_torch.models.common import ParamTree
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import (AdamW, AdamWState, apply_updates,
                                     clip_by_global_norm)


class TrainState(NamedTuple):
    params: ParamTree
    opt: AdamWState
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepConfig:
    remat: str = "nothing_saveable"
    microbatches: int = 1
    loss_chunks: int = 1
    kv_chunk: int = 1024
    clip_norm: float = 1.0
    compress_cross_pod: bool = False


def init_train_state(model: Model, optimizer: AdamW,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Trainable parameters drawn by ``model.init`` (on the card unless
    ``device`` says otherwise), zero moments, step 0."""
    params = model.init(generator, device).requires_grad_()
    opt = optimizer.init(dict(params.named_parameters()))
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


def abstract_train_state(model: Model, optimizer: AdamW) -> TrainState:
    """The state ``init_train_state`` makes, as meta tensors (shapes and
    dtypes, no storage): trainable parameters, fp32 moments, the count and
    the step."""
    params = model.abstract_module().requires_grad_()
    opt = optimizer.init(dict(params.named_parameters()))
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


@torch.no_grad()
def shard_train_state(state: TrainState, model: Model, mesh,
                      rules: ShardingRules) -> TrainState:
    """``state`` laid out on ``mesh``: each parameter (in place) by its
    logical axes, each moment as its parameter; the count and the step
    stay whole on every rank.  Every rank must hold the same state."""
    from torch.distributed.tensor import distribute_tensor

    shard_params(state.params, model.named_specs(), mesh, rules)
    params = dict(state.params.named_parameters())

    def like(tree):
        return {k: distribute_tensor(t, mesh, params[k].placements)
                for k, t in tree.items()}

    return TrainState(params=state.params,
                      opt=state.opt._replace(m=like(state.opt.m),
                                             v=like(state.opt.v)),
                      step=state.step)


def whole(t: torch.Tensor) -> torch.Tensor:
    """The full value of a ``DTensor`` on every rank, a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def loss_and_grads(model: Model, params: ParamTree, batch: Dict,
                   step_cfg: StepConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one (micro)batch and the gradient of every parameter,
    each in its parameter's dtype."""
    kw = dict(remat=step_cfg.remat, loss_chunks=step_cfg.loss_chunks)
    if not (model.cfg.xlstm or model.cfg.mamba_per_attn
            or model.cfg.enc_layers):
        kw["kv_chunk"] = step_cfg.kv_chunk
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = model.loss(params, batch, **kw)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def microbatch(x: torch.Tensor, mbs: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mbs``: rows [i·B/mbs, (i+1)·B/mbs), as the
    JAX package's reshape to (mbs, B/mbs, ...) takes them.  ``DTensor``
    cannot view a batch split over the mesh that way (a dim of ``mbs``
    that the data axis does not divide): a sharded batch is made whole on
    every rank first and the microbatch laid out again by its logical
    axes."""
    if isinstance(x, DTensor):
        x = x.redistribute(x.device_mesh,
                           [Replicate()] * x.device_mesh.ndim)
    mb = x.reshape((mbs, x.shape[0] // mbs) + tuple(x.shape[1:]))[i]
    if isinstance(x, DTensor):
        mb = shard_act(mb, ("batch",) + (None,) * (mb.dim() - 1))
    return mb


def on_mesh(mesh, rules: Optional[ShardingRules]):
    """The context a sharded step runs under: the activation resolver of
    ``mesh`` and ``rules`` (nothing without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return activation_sharding(make_act_resolver(mesh, rules))


def make_train_step(
    model: Model, optimizer: AdamW, step_cfg: StepConfig = StepConfig(),
    mesh=None, rules: Optional[ShardingRules] = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """The step; with ``mesh`` (and its ``rules``) the sharded step of a
    state laid out by ``shard_train_state`` and a batch by
    ``repro_torch.data.pipeline.shard_batch``.  Its metrics are whole
    tensors on every rank."""
    if mesh is not None and rules is None:
        raise ValueError("a sharded step needs the mesh's rules")

    def train_step(state: TrainState, batch: Dict):
        with on_mesh(mesh, rules):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict):
        mbs = step_cfg.microbatches
        if mbs == 1:
            loss, grads = loss_and_grads(model, state.params, batch,
                                         step_cfg)
        else:
            # fp32 accumulators, the loss and gradients averaged over the
            # microbatches, as the JAX package's scan accumulates them
            loss = 0.0
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.named_parameters()}
            for i in range(mbs):
                mb = {k: microbatch(x, mbs, i) for k, x in batch.items()}
                l, g = loss_and_grads(model, state.params, mb, step_cfg)
                for k, t in g.items():
                    grads[k].add_(t.float())
                loss = loss + l
            loss = loss / mbs
            grads = {k: g / mbs for k, g in grads.items()}

        new_state, gnorm = apply_gradients(state, grads, optimizer,
                                           step_cfg)
        metrics = {"loss": whole(loss), "grad_norm": whole(gnorm),
                   "lr": optimizer.lr(new_state.opt.count)}
        return new_state, metrics

    return train_step


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                    optimizer: AdamW, step_cfg: StepConfig
                    ) -> Tuple[TrainState, torch.Tensor]:
    """The step after the gradients: (int8 round trip,) clip, AdamW, in
    place; returns the state with the step advanced and the gradients'
    global norm."""
    params = dict(state.params.named_parameters())
    # DTensor's gradient may be a partial sum or laid out otherwise:
    # reduce it onto its parameter's layout
    grads = {k: g.redistribute(params[k].device_mesh, params[k].placements)
             if isinstance(g, DTensor) else g for k, g in grads.items()}
    if step_cfg.compress_cross_pod:
        grads = quantize_dequantize_tree(grads)
    grads, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
    updates, opt = optimizer.update(grads, state.opt, params)
    apply_updates(params, updates)
    return TrainState(params=state.params, opt=opt,
                      step=state.step + 1), gnorm
