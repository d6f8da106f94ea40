"""The train step, in PyTorch: loss -> gradients (microbatches
accumulated, layers rematerialized) -> optional int8 round trip -> clip ->
AdamW.  The JAX package's ``repro.train.train_step`` carried over, on one
device.

``TrainState.params`` is the model's ``ParamTree`` with trainable leaves;
the optimizer's trees are dicts keyed by its parameter names.  A step
updates the parameters and the moments in place and returns the state
with the count and the step advanced.  Every parameter must receive a
gradient: ``torch.autograd.grad`` raises for one the loss does not reach
(the kernel's output has none unless it is reached through
``KernelAttention``).  The dry-run state (``abstract_train_state``) waits
for ROADMAP.md, queue 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.compression import quantize_dequantize_tree
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


def make_train_step(
    model: Model, optimizer: AdamW, step_cfg: StepConfig = StepConfig(),
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    def train_step(state: TrainState, batch: Dict):
        mbs = step_cfg.microbatches
        if mbs == 1:
            loss, grads = loss_and_grads(model, state.params, batch,
                                         step_cfg)
        else:
            # fp32 accumulators, the loss and gradients averaged over the
            # microbatches, as the JAX package's scan accumulates them
            loss = 0.0
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.named_parameters()}
            for i in range(mbs):
                mb = {k: x.reshape((mbs, x.shape[0] // mbs)
                                   + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                l, g = loss_and_grads(model, state.params, mb, step_cfg)
                for k, t in g.items():
                    grads[k].add_(t.float())
                loss = loss + l
            loss = loss / mbs
            grads = {k: g / mbs for k, g in grads.items()}

        if step_cfg.compress_cross_pod:
            grads = quantize_dequantize_tree(grads)

        grads, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
        params = dict(state.params.named_parameters())
        updates, opt = optimizer.update(grads, state.opt, params)
        apply_updates(params, updates)
        new_state = TrainState(params=state.params, opt=opt,
                               step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": optimizer.lr(opt.count)}
        return new_state, metrics

    return train_step
