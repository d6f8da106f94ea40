"""The ranks of the sharded-step tests (``tests/test_torch_sharding.py``):
each a process of a gloo group on localhost, started by
``torch.multiprocessing``.  This module imports torch and the port only,
so that a rank starts quickly; each case function runs on every rank of
one group and rank 0 saves what the test compares (``torch.save`` into the
case's directory).
"""
import os
import socket
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SMOKES
from repro_torch.data.pipeline import DataConfig, make_batch, shard_batch
from repro_torch.distributed.compression import cross_pod_int8_psum
from repro_torch.distributed.sharding import batch_shardings, default_rules
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, constant_lr
from repro_torch.train.train_step import (StepConfig, TrainState,
                                          apply_gradients, init_train_state,
                                          loss_and_grads, make_train_step,
                                          on_mesh, shard_train_state, whole)
from torch.distributed.device_mesh import init_device_mesh

LR = 1e-3
SEQ = 16


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_group(world: int, case: Callable, *args):
    """``case(rank, *args)`` started on each rank of a new gloo group of
    ``world`` processes; ``wait_group`` joins it."""
    return mp.start_processes(_entry, args=(world, free_port(), case, args),
                              nprocs=world, join=False, start_method="spawn")


def wait_group(ctx, timeout: float) -> None:
    """Join a started group; raises if a rank failed, or if the group has
    not finished within ``timeout`` seconds (its ranks killed then)."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a group of {len(ctx.processes)} ranks "
                                   f"took more than {timeout} s")
    finally:
        stop_group(ctx)


def stop_group(ctx) -> None:
    """Kill a started group's ranks that are still running."""
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()


def run_group(world: int, timeout: float, case: Callable, *args) -> None:
    wait_group(start_group(world, case, *args), timeout)


def _entry(rank: int, world: int, port: int, case: Callable, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        case(rank, *args)
    finally:
        dist.destroy_process_group()


def mesh_of(shape, names=("data", "model")):
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def data_config(cfg, batch: int, step_seq: int = SEQ) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=step_seq,
                      global_batch=batch, frontend=cfg.frontend,
                      frontend_len=cfg.frontend_len,
                      frontend_dim=cfg.frontend_dim)


def load_params(arch: str, path: str):
    """The SMOKE arch's module with the values saved at ``path``."""
    model = build_model(SMOKES[arch])
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    saved = torch.load(path)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(saved[name])
    return model, params.requires_grad_()


def _full(tree: Dict) -> Dict[str, torch.Tensor]:
    return {k: whole(v).detach().clone() for k, v in tree.items()}


def step_case(rank: int, plan, batch: int, indir: str, outdir: str
              ) -> None:
    """For each (mesh shape, arch, microbatches) of ``plan``: with one
    microbatch the sharded loss and every gradient (gathered), then
    ``apply_gradients`` (clip, AdamW on the local shards) and the
    parameters after it (gathered); with more, one sharded
    ``make_train_step``'s metrics."""
    rules = default_rules(multi_pod=False)
    meshes = {}
    for shape, arch, microbatches in plan:
        if shape not in meshes:
            meshes[shape] = mesh_of(shape)
        mesh = meshes[shape]
        cfg = SMOKES[arch]
        host = make_batch(data_config(cfg, batch), 0)
        model, params = load_params(arch, os.path.join(indir, f"{arch}.pt"))
        opt = AdamW(lr=constant_lr(LR))
        state = TrainState(params=params,
                           opt=opt.init(dict(params.named_parameters())),
                           step=torch.zeros((), dtype=torch.int32))
        state = shard_train_state(state, model, mesh, rules)
        sb = shard_batch(host, batch_shardings(mesh, rules, host))
        scfg = StepConfig(microbatches=microbatches)
        if microbatches == 1:
            with on_mesh(mesh, rules):
                loss, grads = loss_and_grads(model, state.params, sb, scfg)
                out = {"loss": float(whole(loss)), "grads": _full(grads)}
                state, gnorm = apply_gradients(state, grads, opt, scfg)
            out["grad_norm"] = float(whole(gnorm))
        else:
            state, metrics = make_train_step(model, opt, scfg, mesh=mesh,
                                             rules=rules)(state, sb)
            out = {"loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}
        out["params"] = _full(dict(state.params.named_parameters()))
        if rank == 0:
            torch.save(out, os.path.join(
                outdir, f"{shape[0]}x{shape[1]}-{arch}-mb{microbatches}.pt"))


def checkpoint_case(rank: int, arch: str, indir: str, outdir: str) -> None:
    """2x2: one sharded step, its state gathered (rank 0 saves it) and
    checkpointed; the checkpoint restored into a fresh sharded template
    must give the same full tensors."""
    rules = default_rules(multi_pod=False)
    mesh = mesh_of((2, 2))
    cfg = SMOKES[arch]
    model, params = load_params(arch, os.path.join(indir, f"{arch}.pt"))
    opt = AdamW(lr=constant_lr(LR))
    state = shard_train_state(
        TrainState(params=params, opt=opt.init(dict(
            params.named_parameters())),
            step=torch.zeros((), dtype=torch.int32)), model, mesh, rules)
    host = make_batch(data_config(cfg, 4), 0)
    state, _ = make_train_step(model, opt, StepConfig(), mesh=mesh,
                               rules=rules)(
        state, shard_batch(host, batch_shardings(mesh, rules, host)))
    ck = Checkpointer(os.path.join(outdir, "ckpt"), async_write=False)
    ck.save(1, state)
    dist.barrier()
    gathered = {"params": _full(dict(state.params.named_parameters())),
                "m": _full(state.opt.m), "v": _full(state.opt.v)}
    fresh = shard_train_state(
        init_train_state(model, opt, torch.Generator().manual_seed(3),
                         "cpu"), model, mesh, rules)
    step, restored = ck.restore_latest(fresh)
    again = {"params": _full(dict(restored.params.named_parameters())),
             "m": _full(restored.opt.m), "v": _full(restored.opt.v)}
    same = step == 1 and all(
        torch.equal(gathered[t][k], again[t][k])
        for t in gathered for k in gathered[t])
    if rank == 0:
        torch.save({"state": gathered, "restored_under_2x2": same,
                    "count": int(restored.opt.count),
                    "step": int(restored.step)},
                   os.path.join(outdir, "ckpt_state.pt"))


def batch_case(rank: int, meshes, archs, batch: int, outdir: str) -> None:
    """``shard_batch``'s global batch, and each rank's block, against
    ``make_batch``'s."""
    rules = default_rules(multi_pod=False)
    ok = True
    for shape in meshes:
        mesh = mesh_of(shape)
        for arch in archs:
            host = make_batch(data_config(SMOKES[arch], batch), 7)
            sb = shard_batch(host, batch_shardings(mesh, rules, host))
            for k, v in host.items():
                full = sb[k].full_tensor().numpy()
                local = sb[k].to_local().numpy()
                d = mesh.get_coordinate()[0]
                rows = v.shape[0] // shape[0]
                ok &= (full.dtype == v.dtype and np.array_equal(full, v)
                       and np.array_equal(local,
                                          v[d * rows:(d + 1) * rows]))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, ok)
    if rank == 0:
        torch.save({"ok": flags}, os.path.join(outdir, "batch.pt"))


def int8_case(rank: int, path: str, outdir: str) -> None:
    """``cross_pod_int8_psum`` of this rank's row of the stacked leaves."""
    stacked = torch.load(path)
    out = cross_pod_int8_psum({k: v[rank] for k, v in stacked.items()})
    torch.save(out, os.path.join(outdir, f"int8-{rank}.pt"))


def local_helpers_case(rank: int, outdir: str) -> None:
    """On a 2x2 mesh, with integer values (so that a sum in any order is
    exact): ``api.index_add_`` on a buffer split over "model" along its
    other dim; the MoE's ``combine_experts`` with the experts over "model"
    and the embed dim over "data", as the capacity dispatch lays them out;
    the mLSTM decode's read-out through ``call_local`` on a state split
    over batch and heads.  Each sharded result made whole beside the
    unsharded op on the same values."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.api import (activation_sharding,
                                             call_local, index_add_)
    from repro_torch.distributed.sharding import make_act_resolver
    from repro_torch.models import xlstm
    from repro_torch.models.moe import combine_experts

    mesh = mesh_of((2, 2))
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g).float()

    got, want = {}, {}
    buf, src = ints(8, 6), ints(10, 6)
    index = torch.randint(0, 8, (10,), generator=g)
    want["index_add_"] = buf.clone().index_add_(0, index, src)
    got["index_add_"] = index_add_(
        distribute_tensor(buf, mesh, [Replicate(), Shard(1)]), 0, index,
        distribute_tensor(src, mesh, [Shard(0), Replicate()])).full_tensor()

    combine, yout = ints(2, 6, 4, 3), ints(4, 2, 3, 8)
    want["combine_experts"] = torch.einsum("gtec,egcd->gtd", combine, yout)
    for name, pl in (("replicated", [Replicate(), Replicate()]),
                     ("batch over data", [Shard(0), Replicate()])):
        got[f"combine_experts, combine {name}"] = combine_experts(
            distribute_tensor(combine, mesh, pl),
            distribute_tensor(yout, mesh, [Shard(3), Shard(0)])).full_tensor()
        want[f"combine_experts, combine {name}"] = want["combine_experts"]
    del want["combine_experts"]

    q, c, n = ints(4, 2, 8), ints(4, 2, 8, 8), ints(4, 2, 8)
    want["_mlstm_readout"] = xlstm._mlstm_readout(q, c, n)
    split = [Shard(0), Shard(1)]
    with activation_sharding(make_act_resolver(mesh,
                                               default_rules(False))):
        got["_mlstm_readout"] = call_local(
            xlstm._mlstm_readout,
            tuple(distribute_tensor(x, mesh, split) for x in (q, c, n)),
            (("batch", "heads", None), ("batch", "heads", None, None),
             ("batch", "heads", None)),
            ("batch", "heads", None)).full_tensor()
    if rank == 0:
        torch.save({k: (got[k], want[k]) for k in want},
                   os.path.join(outdir, "local_helpers.pt"))
