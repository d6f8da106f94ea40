"""Checkpoints of a train state: atomic, asynchronous, keep-last-k, in the
JAX package's layout (``repro.checkpoint.checkpointer``), so that each
package's checkpoints restore in the other.

A checkpoint is ``step_<10 digits>/`` holding ``arrays.npz`` and
``meta.json`` (``{"step", "leaves", "format": 1}``).  Its leaves are keyed
as the JAX package flattens a ``TrainState``: ``params/<path>``,
``opt/m/<path>``, ``opt/v/<path>``, ``opt/count`` and ``step``, where
``<path>`` is the parameter's path in the JAX params with the layer
indices left out (``blocks.3.attn.wq`` is ``blocks/attn/wq``), and a
stacked leaf is written whole with its layers axes (``leaf_key``,
``stacked``).  bf16 leaves are written as 2-byte voids (``|V2``), the
bytes ``numpy.asarray`` of a JAX bf16 array saves, and a ``|V2`` leaf is
restored as bf16 where the template's leaf is bf16, bit for bit.

Writes go to ``step_….tmp`` and are renamed when complete; a background
thread serializes, so the train loop blocks only on the device-to-host
copy.  An error of the writer is raised by the next ``wait`` or ``save``.

A sharded state (``DTensor`` leaves, ``train_step.shard_train_state``) is
gathered to full tensors by every rank and written by rank 0 alone, in
the same layout; a restore reads the full leaves on every rank and lays
each out as its template's leaf, so that a checkpoint written under any
mesh restores under any other.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.optim.adamw import AdamWState
from repro_torch.train.train_step import TrainState, whole

FORMAT = 1
_VOID2 = np.dtype("V2")


def leaf_key(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A parameter's name in the port's module (``supers.1.2.mamba.w_in``)
    as its leaf's key in the JAX params (``supers/mamba/w_in``) and its
    index along the leaf's layers axes (``(1, 2)``)."""
    parts = name.split(".")
    return ("/".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def stacked(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors keyed by parameter name as the JAX params' leaves: the
    layers' tensors of one leaf stacked along its layers axes."""
    groups: Dict[str, List] = {}
    for name, t in named.items():
        key, index = leaf_key(name)
        groups.setdefault(key, []).append((index, t))
    out = {}
    for key, items in groups.items():
        index, t0 = items[0]
        if not index:
            out[key] = t0
            continue
        lead = tuple(max(ix[d] for ix, _ in items) + 1
                     for d in range(len(index)))
        if math.prod(lead) != len(items):
            raise ValueError(f"{key}: {len(items)} layers do not fill the "
                             f"layers axes {lead}")
        items.sort(key=lambda it: it[0])
        out[key] = torch.stack([t for _, t in items]).reshape(
            lead + tuple(t0.shape))
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    # a copy even on the CPU: the next step updates the state in place
    # while the writer serializes (a DTensor gathered whole first)
    return whole(t.detach()).to("cpu", copy=True)


def state_arrays(state: TrainState) -> Dict[str, np.ndarray]:
    """The checkpoint's leaves of ``state`` as host arrays."""
    trees = (("params", {k: _host(p) for k, p in
                         state.params.named_parameters()}),
             ("opt/m", {k: _host(t) for k, t in state.opt.m.items()}),
             ("opt/v", {k: _host(t) for k, t in state.opt.v.items()}))
    flat = {f"{prefix}/{k}": t for prefix, tree in trees
            for k, t in stacked(tree).items()}
    flat["opt/count"] = _host(state.opt.count)
    flat["step"] = _host(state.step)
    return {k: _to_numpy(t) for k, t in flat.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_VOID2)
    return t.contiguous().numpy()


def _to_tensor(key: str, arr: np.ndarray, dtype: torch.dtype
               ) -> torch.Tensor:
    """A saved leaf as a tensor of the template's ``dtype``: a 2-byte void
    (or an ``ml_dtypes`` bf16) is bf16's bits; any other dtype must be the
    template's."""
    if arr.dtype == _VOID2 or arr.dtype.name == "bfloat16":
        if dtype != torch.bfloat16:
            raise ValueError(f"{key}: a bf16 leaf in the checkpoint, "
                             f"{dtype} in the template")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    if t.dtype != dtype:
        raise ValueError(f"{key}: {t.dtype} in the checkpoint, {dtype} in "
                         f"the template")
    return t


@torch.no_grad()
def load_arrays(template: TrainState, flat: Dict[str, np.ndarray]
                ) -> TrainState:
    """``flat`` (a checkpoint's leaves) copied into ``template``'s tensors
    in place; returns the state with the checkpoint's count and step."""
    loaded: Dict[str, torch.Tensor] = {}

    def leaf(key: str, like: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if key not in loaded:
            loaded[key] = _to_tensor(key, flat[key], like.dtype)
        return loaded[key]

    def fill(prefix: str, named) -> None:
        for name, t in named:
            key, index = leaf_key(name)
            src = leaf(f"{prefix}/{key}", t)[index]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{prefix}/{key}{list(index)}: shape "
                                 f"{tuple(src.shape)} in the checkpoint, "
                                 f"{tuple(t.shape)} in the template")
            if isinstance(t, DTensor):
                src = distribute_tensor(src.to(t.device), t.device_mesh,
                                        t.placements)
            t.copy_(src)

    fill("params", template.params.named_parameters())
    fill("opt/m", template.opt.m.items())
    fill("opt/v", template.opt.v.items())
    count = leaf("opt/count", template.opt.count)
    step = leaf("step", template.step)
    dev = template.step.device
    return TrainState(params=template.params,
                      opt=AdamWState(m=template.opt.m, v=template.opt.v,
                                     count=count.to(dev)),
                      step=step.to(dev))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: TrainState) -> None:
        """Device-to-host copy now; serialization in the background unless
        ``async_write`` is off."""
        host = state_arrays(state)
        if dist.is_initialized() and dist.get_rank() != 0:
            return       # rank 0 writes the gathered state
        self.wait()  # one write in flight at a time
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_catching, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_catching(self, step: int, host: Dict[str, np.ndarray]):
        try:
            self._write(step, host)
        except Exception as e:   # raised again by wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        meta = {"step": step, "leaves": sorted(host), "format": FORMAT}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        """Wait for the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: TrainState) -> TrainState:
        """The checkpoint of ``step`` loaded into ``template``'s tensors
        (in place, on their devices)."""
        path = os.path.join(self.directory, f"step_{step:010d}",
                            "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return load_arrays(template, flat)

    def restore_latest(self, template: TrainState):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)
