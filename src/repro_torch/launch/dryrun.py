"""Multi-pod dry run: count every (arch × shape × mesh) cell's step.

The JAX package's ``repro.launch.dryrun`` lowers and compiles each cell's
step for 256 or 512 TPU chips on host devices that XLA fakes, parses the
HLO and prices it.  Here the same step runs in PyTorch on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage), as rank 0 of a fake
process group of 256 or 512 ranks (``launch.mesh.make_production_mesh``),
through the port's own entry points: the train cell is
``make_train_step(model, AdamW, StepConfig, mesh=...)`` over
``shard_train_state`` of ``abstract_train_state``, the prefill and decode
cells ``Model.prefill`` and ``Model.decode`` with the parameters laid out
by their logical axes (``shard_params``, the layouts ``param_shardings``
gives), the batch by ``batch_shardings`` and the cache by
``cache_shardings``.  ``roofline.op_count``
counts rank 0's local ops (the dry run's counters) and
``roofline.analysis`` prices them at the H100's rates.  Nothing is
allocated and nothing is launched: no card is needed.

Run as

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
        --shape train_4k --mesh single --out results.jsonl

or with --all to sweep every cell.  Each cell prints its per-device
memory (the peak of live storages: parameters, moments, activations,
gradients) and its counts, and appends a JSON record with the JAX
record's keys; ``lower_s`` is the seconds to build the fake state and its
layouts, ``compile_s`` the seconds of the counted step.  ``--sites`` adds
a ``sites`` key: the collective seconds and bytes and the peak's bytes by
the call site that issued them (``roofline.analysis.site_summary``).

Fake tensors hold no values, so the dropless MoE cannot read its routing:
while a step is counted, ``models.moe.group_sizes`` gives every expert its
expected load, the tokens spread evenly (``expected_loads``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_count import OpCount, OpCounter
from repro_torch.train.train_step import StepConfig


# Per-(arch, shape) step-config overrides: microbatches bound the live
# activation footprint; loss_chunks bound the (tokens, vocab) logits buffer.
def step_config_for(arch_name: str, shape_name: str,
                    overrides=None) -> StepConfig:
    big = arch_name in ("deepseek-v2-236b", "command-r-plus-104b",
                        "internvl2-76b", "llama4-scout-17b-a16e")
    cfg = dict(
        remat="nothing_saveable",
        microbatches=8 if big else 2,
        loss_chunks=8,
        kv_chunk=2048,
    )
    if overrides:
        cfg.update(overrides)
    return StepConfig(**cfg)


def fake_like(t: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor of ``t``'s shape and dtype (inside a
    ``FakeTensorMode``)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype)


def fake_params(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter of ``module`` replaced, in place, by a fake CPU
    tensor of its shape, keeping ``requires_grad``."""
    for mod in module.modules():
        for k, p in list(mod._parameters.items()):
            mod._parameters[k] = torch.nn.Parameter(
                fake_like(p), requires_grad=p.requires_grad)
    return module


def place(tree, layouts):
    """A tree of meta stand-ins as fake ``DTensor``s laid out by
    ``layouts`` (``Layout`` leaves): each leaf rank 0's local block."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_slices

    if isinstance(tree, dict):
        return {k: place(tree[k], layouts[k]) for k in tree}
    lay = layouts
    block = local_slices(lay.mesh, lay.spec, tuple(tree.shape))
    local = torch.empty(tuple(s.stop - s.start for s in block),
                        dtype=tree.dtype)
    return DTensor.from_local(local, lay.mesh, lay.placements,
                              run_check=False, shape=tuple(tree.shape),
                              stride=tuple(tree.stride()))


def fake_train_state(model, optimizer):
    """``abstract_train_state`` as fake CPU tensors (inside a
    ``FakeTensorMode``)."""
    from repro_torch.train.train_step import abstract_train_state

    state = abstract_train_state(model, optimizer)
    return state._replace(
        params=fake_params(state.params),
        opt=state.opt._replace(
            m={k: fake_like(t) for k, t in state.opt.m.items()},
            v={k: fake_like(t) for k, t in state.opt.v.items()},
            count=fake_like(state.opt.count)),
        step=fake_like(state.step))


def train_args(model, optimizer, step_cfg: StepConfig, batch_abs,
               mesh=None, rules=None):
    """(step, (state, batch)) of a train step on fake tensors (inside a
    ``FakeTensorMode``): the plain step, or with ``mesh`` the sharded one
    over ``shard_train_state`` and a batch laid out by ``batch_shardings``."""
    from repro_torch.distributed.sharding import batch_shardings
    from repro_torch.train.train_step import (make_train_step,
                                              shard_train_state)

    state = fake_train_state(model, optimizer)
    if mesh is None:
        batch = {k: fake_like(t) for k, t in batch_abs.items()}
    else:
        state = shard_train_state(state, model, mesh, rules)
        batch = place(batch_abs, batch_shardings(mesh, rules, batch_abs))
    step = make_train_step(model, optimizer, step_cfg, mesh=mesh,
                           rules=rules)
    return step, (state, batch)


def _even_loads(flat_expert: torch.Tensor, e: int):
    n = flat_expert.numel()
    return [n // e + (1 if i < n % e else 0) for i in range(e)]


@contextlib.contextmanager
def expected_loads():
    """While open, the dropless MoE's group sizes are the experts' expected
    loads (the routed tokens spread evenly) instead of a read of the
    routing, which fake tensors do not hold."""
    from repro_torch.models import moe

    real, moe.group_sizes = moe.group_sizes, _even_loads
    try:
        yield
    finally:
        moe.group_sizes = real


def counted(step, args, sites: bool = False) -> Tuple[OpCount, float]:
    """``step(*args)`` under an ``OpCounter`` that holds ``args`` live from
    the start: its count and the bytes of its outputs' storages."""
    counter = OpCounter(sites=sites)
    with expected_loads(), counter:
        counter.track(args)
        out = step(*args)
    return counter.count, storage_bytes(out)


def count_train_step(arch: str, step_cfg: StepConfig, batch: int, seq: int,
                     sharded: bool = False) -> OpCount:
    """The count of one train step of ``arch`` at ``batch`` × ``seq``
    under ``step_cfg``: the plain step, or with ``sharded`` the sharded
    step on a one-rank fake mesh under the single-pod rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.config import ShapeConfig

    model = build_model(ARCHS[arch])
    optimizer = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
    batch_abs = model.input_specs(ShapeConfig("step", seq, batch, "train"))
    with (fake_mesh((1, 1), ("data", "model")) if sharded
          else contextlib.nullcontext()) as mesh, FakeTensorMode():
        rules = default_rules(multi_pod=False)
        step, args = train_args(model, optimizer, step_cfg, batch_abs,
                                mesh, rules)
        count, _ = counted(step, args)
        del step, args
    return count


def storage_bytes(tree) -> float:
    """The bytes of the distinct storages of a tree's tensors (modules'
    parameters, a ``DTensor`` by its local tensor)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    seen, total = set(), 0.0
    for leaf in tree_flatten(tree)[0]:
        tensors = ([*leaf.parameters()] if isinstance(leaf, torch.nn.Module)
                   else [leaf])
        for t in tensors:
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in seen:
                    seen.add(st._cdata)
                    total += st.nbytes()
    return total


def count_cell(arch_name: str, shape_name: str, multi_pod: bool,
               step_overrides=None, rules_overrides=None,
               sites: bool = False,
               config=None) -> Tuple[Dict, Optional[OpCount]]:
    """``lower_cell``'s record and the ``OpCount`` behind it (None for a
    skipped cell); with ``sites``, the record's ``sites`` too.  ``config``,
    a ``ModelConfig``, is counted under ``arch_name`` in place of
    ``ARCHS[arch_name]``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (batch_shardings,
                                                  cache_shardings,
                                                  default_rules,
                                                  shard_params)
    from repro_torch.launch import mesh as meshes
    from repro_torch.train.train_step import on_mesh

    mesh_name = "multi" if multi_pod else "single"
    arch = ARCHS[arch_name] if config is None else config
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}, None

    rules = default_rules(multi_pod=multi_pod)
    if rules_overrides:
        rules = rules.replace(**rules_overrides)
    model = build_model(arch)
    t0 = time.time()
    with meshes.fake_mesh(*meshes.production_shape(multi_pod)) as mesh, \
            FakeTensorMode():
        chips = mesh.size()
        batch_abs = model.input_specs(shape)
        if shape.kind == "train":
            scfg = step_config_for(arch_name, shape_name, step_overrides)
            optimizer = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
            step, args = train_args(model, optimizer, scfg, batch_abs, mesh,
                                    rules)
            tokens = shape.global_batch * shape.seq_len
            mflops = roofline.model_flops_train(
                model.active_param_count(), tokens)
        else:
            batch = place(batch_abs, batch_shardings(mesh, rules, batch_abs))
            params = shard_params(fake_params(model.abstract_module()),
                                  model.named_specs(), mesh, rules)
            if shape.kind == "prefill":
                def step(params, batch):
                    with on_mesh(mesh, rules), torch.no_grad():
                        return model.prefill(params, batch,
                                             max_seq=shape.seq_len)

                args = (params, batch)
                tokens = shape.global_batch * shape.seq_len
            else:  # decode
                cache_abs = model.cache_specs(shape.global_batch,
                                              shape.seq_len)
                cache = place(cache_abs, cache_shardings(
                    mesh, rules, cache_abs, shape.global_batch,
                    shape.seq_len))

                def step(params, cache, batch):
                    with on_mesh(mesh, rules), torch.no_grad():
                        return model.decode(params, cache, batch)

                args = (params, cache, batch)
                tokens = shape.global_batch
            mflops = roofline.model_flops_decode(
                model.active_param_count(), tokens)
        t_lower = time.time() - t0
        count, output_bytes = counted(step, args, sites)
        t_compile = time.time() - t0 - t_lower
        del step, args
    rf = roofline.analyze_count(count, chips=chips, model_flops=mflops)
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": count.argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": count.peak_bytes - count.argument_bytes,
            "peak_bytes": count.peak_bytes,
        },
        "roofline": rf.summary(),
    }
    if sites:
        rec["sites"] = roofline.site_summary(count)
    return rec, count


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool,
               step_overrides=None, rules_overrides=None,
               verbose: bool = True, sites: bool = False, config=None):
    """Count one cell's step on the production mesh; its record (the
    JAX record's keys and status values, and ``sites`` with ``sites``).
    ``config`` as in ``count_cell``."""
    rec, count = count_cell(arch_name, shape_name, multi_pod,
                            step_overrides, rules_overrides, sites, config)
    if verbose and count is not None:
        rf, mem = rec["roofline"], rec["memory"]
        print(f"[dryrun] {arch_name} x {shape_name} x {rec['mesh']}: "
              f"set-up {rec['lower_s']:.1f}s counted step "
              f"{rec['compile_s']:.1f}s")
        print(f"  memory: args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB "
              f"peak={mem['peak_bytes']/2**30:.2f}GiB (per device)")
        print(f"  counts: flops bf16={count.flops['bf16']:.3e} "
              f"fp32={count.flops['fp32']:.3e} "
              f"tf32x3={count.flops['tf32x3']:.3e} "
              f"bytes={count.bytes:.3e} coll={rf['collective_bytes']:.3e}B "
              f"launches={count.launches} (per device)")
        print(f"  roofline (H100 SXM): compute={rf['compute_s']*1e3:.2f}ms "
              f"memory={rf['memory_s']*1e3:.2f}ms "
              f"collective={rf['collective_s']*1e3:.2f}ms "
              f"-> {rf['dominant']}-bound; "
              f"useful={rf['useful_flops_ratio']:.2f}")
        for site, sec in list(rec.get("sites", {}).get(
                "collective_s", {}).items())[:5]:
            print(f"  collectives at {site}: {sec*1e3:.2f}ms")
        for site, b in list(rec.get("sites", {}).get(
                "peak_bytes", {}).items())[:5]:
            print(f"  at the peak, {site}: {b/2**30:.2f}GiB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sites", action="store_true",
                    help="add each record's collectives and peak bytes by "
                         "call site")
    args = ap.parse_args(argv)

    cells = []
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    out = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shape, mp in cells:
        try:
            rec = lower_cell(arch, shape, mp, sites=args.sites)
        except Exception as e:  # noqa: BLE001 — record and continue
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "mesh": "multi" if mp else "single",
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    if out:
        out.close()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
