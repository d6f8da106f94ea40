"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline.op_count``,
``roofline.analysis``, ``launch.mesh.make_production_mesh``, the abstract
trees of ``models.registry`` and ``train.train_step``) against the JAX
package's and against hand counts.

* The abstract trees (meta tensors) equal the JAX ``ShapeDtypeStruct``
  trees leaf for leaf, shape and dtype, for every arch at full size and
  every applicable shape; the train state's layers stacked as the JAX
  state stacks them (``checkpointer.stacked``).
* The op counter meets its hand counts: a sharded product counted once
  (DTensor's shape pass skipped), every layer of a loop counted, exp's
  transcendentals, the bytes of known redistributions, peak live bytes,
  the attention kernel as one launch a call.
* ``lower_cell``'s skipped records equal the JAX ones for every (arch,
  shape, mesh), and an ok record has the JAX record's keys.
* A SMOKE arch's train, prefill and decode cells, on a 2×2 and a 1×1
  fake mesh, against the JAX dry run on host meshes of the same shapes
  (``tests/_torch_jax_dryrun.py``, in a subprocess: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS``).  ``model_flops`` are equal.
  On one device the dense layers' products are equal flop for flop (the
  train and prefill cells' rank-2 dots against the port's ``mm``; the
  decode cell's dots in all against the port's products in all, the two
  packages splitting its products into dots and batched dots otherwise).
  They differ in attention: the port counts the kernel's causal pairs,
  the JAX parser its chunked attention padded to its 1024-query and
  256-key chunks.  On the 2×2 mesh the port's per-device dense products
  are above the JAX ones (measured on torch 2.13: train 1.1304, prefill
  1.2215, decode 1.5366): DTensor's layouts compute some products whole
  on every rank of the model axis that GSPMD splits (the replicated kv
  projections, the decode logits, the dropless MoE's tokens).  Each cell
  is held to a band of its own around its reading (``MESH_BANDS``).
* The SMOKE MoE archs' cells on the 2×2 mesh, counted under torch 2.11's
  DTensor gaps (``tests/_torch_dtensor_211.py``: the card's torch refuses
  a strict view that flattens a split dim it does not lead, and
  ``index_add_``), against the JAX dry run: ``model_flops`` equal, the
  per-device products in a band around each reading (``MOE_BANDS``, the
  same products as the dense arch's).  They are below the JAX ones, most
  in training: the two packages split the experts' work differently (the
  port's capacity dispatch and combine are batched products of its
  layouts, its dropless MoE multiplies each expert's expected load, where
  the JAX parser counts XLA's rank-2 dots and ``ragged_dot``); their
  products in all are held to the JAX dot flops in all the same way
  (``MOE_ALL_BANDS``).  The capacity combine, the product the gaps
  changed, is held to its hand count at rank 0's share.  xlstm-125m's
  decode counts under the gaps too, and the old combine (one ``einsum``)
  does not.
* The counts by call site (``OpCounter(sites=True)``) add up to the
  totals, and name the embedding table's gather and the dropless MoE's
  replicated tokens apart.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import shape_applicable
from repro.models.registry import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import warmup_cosine as jwarmup
from repro.roofline import analysis as janalysis
from repro.train.train_step import abstract_train_state as jabstract_state
from _torch_dtensor_211 import torch_211_gaps
from repro_torch.checkpoint.checkpointer import stacked
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.core import hwspec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_mesh, free_port,
                                     make_production_mesh)
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.roofline import analysis
from repro_torch.roofline.op_count import OpCount, count_ops
from repro_torch.train.train_step import StepConfig, abstract_train_state

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 128, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode")}
SMOKE_ARCH = "qwen2.5-3b"
# port / JAX per-device dense products on the 2x2 mesh, a band around
# each cell's reading (train 1.1304, prefill 1.2215, decode 1.5366; see
# the module's docstring)
MESH_BANDS = {"train_4k": (1.12, 1.14), "prefill_32k": (1.21, 1.23),
              "decode_32k": (1.52, 1.55)}
MOE_ARCHS = ("deepseek-v2-236b", "llama4-scout-17b-a16e")
# the same ratio for the MoE archs on the 2x2 mesh, a band around each
# reading (torch 2.13; the module's docstring says why they are below 1)
MOE_BANDS = {("deepseek-v2-236b", "train_4k"): (0.68, 0.70),
             ("deepseek-v2-236b", "prefill_32k"): (0.436, 0.448),
             ("deepseek-v2-236b", "decode_32k"): (0.70, 0.72),
             ("llama4-scout-17b-a16e", "train_4k"): (0.087, 0.090),
             ("llama4-scout-17b-a16e", "prefill_32k"): (0.66, 0.68),
             ("llama4-scout-17b-a16e", "decode_32k"): (0.82, 0.84)}
# the port's products in all (its kernel's included) over the JAX dot
# flops in all, on the same cells, a band around each reading (torch
# 2.13 under the gaps: deepseek 0.1556 train, 0.2623 prefill; llama4
# 0.1868, 0.3715); decode's MOE_BANDS already compare all products
MOE_ALL_BANDS = {("deepseek-v2-236b", "train_4k"): (0.153, 0.158),
                 ("deepseek-v2-236b", "prefill_32k"): (0.258, 0.266),
                 ("llama4-scout-17b-a16e", "train_4k"): (0.184, 0.190),
                 ("llama4-scout-17b-a16e", "prefill_32k"): (0.366, 0.377)}


def _jflat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jflat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): (tuple(tree.shape), np.dtype(tree.dtype).name)}


def _pflat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_pflat(v, prefix + (k,)))
        return out
    assert tree.device.type == "meta"
    return {"/".join(prefix): (tuple(tree.shape),
                               str(tree.dtype).replace("torch.", ""))}


# =============================================================================
# The abstract trees
# =============================================================================
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_equal_the_jax_ones(arch):
    jm, pm = jbuild(JARCHS[arch]), build_model(ARCHS[arch])
    assert _pflat(pm.abstract()) == _jflat(jm.abstract())
    for name, shape in SHAPES.items():
        if not shape_applicable(JARCHS[arch], JSHAPES[name])[0]:
            continue
        assert _pflat(pm.input_specs(shape)) \
            == _jflat(jm.input_specs(JSHAPES[name])), name
        if shape.kind == "decode":
            assert _pflat(pm.cache_specs(shape.global_batch,
                                         shape.seq_len)) \
                == _jflat(jm.cache_specs(shape.global_batch,
                                         shape.seq_len)), name
    # the module of meta parameters: the same leaves once restacked
    module = pm.abstract_module()
    assert all(p.device.type == "meta" for p in module.parameters())
    assert _pflat(stacked(dict(module.named_parameters()))) \
        == _jflat(jm.abstract())

    js = jabstract_state(jm, JAdamW(lr=jwarmup(3e-4, 2000, 100000)))
    ps = abstract_train_state(pm, AdamW(lr=warmup_cosine(3e-4, 2000,
                                                         100000)))
    assert all(p.requires_grad for p in ps.params.parameters())
    assert _pflat(stacked(dict(ps.params.named_parameters()))) \
        == _jflat(js.params)
    assert _pflat(stacked(ps.opt.m)) == _jflat(js.opt.m)
    assert _pflat(stacked(ps.opt.v)) == _jflat(js.opt.v)
    assert _pflat({"count": ps.opt.count, "step": ps.step}) \
        == _jflat({"count": js.opt.count, "step": js.step})


def test_the_bf16_rate_leaves_the_hardware_keys_as_they_were():
    assert hwspec.H100_SXM.bf16_flops == 989e12
    assert hwspec.H100_PCIE.bf16_flops == 756e12
    assert hwspec.hardware_key(hwspec.H100_SXM) == "h100_sxm"
    assert hwspec.hardware_key(hwspec.H100_PCIE) == "h100_pcie"
    custom = hwspec.H100_SXM.__class__(
        **{**hwspec.H100_SXM.__dict__, "name": "my_card"})
    assert hwspec.fingerprint(custom) == "my_card-67tf-3350gbs"
    assert hwspec.hardware_key(custom) == "my_card-67tf-3350gbs"
    assert hwspec.fingerprint(hwspec.H100_PCIE) == "h100_pcie-51tf-2000gbs"


# =============================================================================
# The production meshes
# =============================================================================
@pytest.mark.parametrize("multi_pod", [False, True])
def test_the_production_meshes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
            else ((16, 16), ("data", "model"))
        assert tuple(mesh.shape) == shape
        assert tuple(mesh.mesh_dim_names) == names
        assert mesh.size() == math.prod(shape)
        assert dist.get_backend() == "fake" and dist.get_rank() == 0
        assert dist.get_world_size() == math.prod(shape)
        assert tuple(mesh.get_coordinate()) == (0,) * len(shape)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_the_fake_group_is_refused_while_a_group_is_live():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a gloo group of 1 ranks"):
            make_production_mesh()
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        assert mesh.size() == 4
    assert not dist.is_initialized()


# =============================================================================
# The op counter against hand counts
# =============================================================================
def test_a_sharded_product_is_counted_once_at_rank_0s_share():
    """x (4096, 8192) split by rows over 4 ranks, w (8192, 8192) whole:
    rank 0's product is 2·1024·8192² flops, not the global product's, and
    not twice (DTensor's shape pass runs the op on the global shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_mesh((4,), ("data",)) as mesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty(1024, 8192), mesh, [Shard(0)],
                               run_check=False)
        w = DTensor.from_local(torch.empty(8192, 8192), mesh, [Replicate()],
                               run_check=False)
        y, c = count_ops(lambda: x @ w, track=(x, w))
        assert tuple(y.shape) == (4096, 8192)
    assert c.flops == {"bf16": 0.0, "fp32": 2.0 * 1024 * 8192 ** 2,
                       "tf32x3": 0.0}
    assert c.product_flops_by_op == {"mm": 2.0 * 1024 * 8192 ** 2}
    local = (1024 * 8192 * 2 + 8192 * 8192) * 4   # x, w read; y written
    assert c.bytes == local
    assert c.argument_bytes == (1024 + 8192) * 8192 * 4
    assert c.peak_bytes == local
    assert c.ops == 1


def test_every_layer_of_a_loop_is_counted():
    """The counterpart of the HLO parser's scan test: seven layers of
    tanh(h @ w) at 128² within 5 % of 7·2·128³."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(h, ws):
        for i in range(7):
            h = torch.tanh(h @ ws[i])
        return h

    with FakeTensorMode():
        h, ws = torch.empty(128, 128), torch.empty(7, 128, 128)
        _, c = count_ops(f, h, ws)
    expect = 7 * 2 * 128 ** 3
    assert abs(c.total_flops - expect) / expect < 0.05
    assert c.transcendentals == 7 * 128 * 128


def test_transcendentals():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1024)
        _, c = count_ops(lambda: torch.exp(x).sum())
    assert c.transcendentals >= 1024


def test_collective_bytes_of_known_redistributions():
    """On a 2×2 fake mesh: a (64, 128) fp32 tensor split on both axes
    gathered whole is two all-gathers, of 64·128·4/2 and 64·128·4 bytes
    a rank; a partial sum of (64,) reduced is one all-reduce of 256."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_mesh((2, 2), ("data", "model")) as mesh, FakeTensorMode():
        a = DTensor.from_local(torch.empty(32, 64), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        _, c = count_ops(lambda: a.redistribute(mesh, [Replicate()] * 2))
        assert c.collective_counts == {"all-gather": 2}
        assert c.collective_bytes == {"all-gather": 64 * 128 * 4 / 2
                                      + 64 * 128 * 4}
        assert c.collective_links == {"nvlink": c.collective_bytes}
        p = DTensor.from_local(torch.empty(64, 64), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        s = p.sum(dim=1)
        assert s.placements[1].is_partial()
        _, c = count_ops(lambda: s.redistribute(mesh, [Replicate()] * 2))
        assert c.collective_counts == {"all-reduce": 1}
        assert c.collective_bytes == {"all-reduce": 256.0}


def test_peak_live_bytes_follow_the_storages():
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(x):
        a = x * 2          # 4 MB
        b = a + 1          # 4 MB, with a and x: the peak
        del a
        return b.sum()     # 4 bytes, a freed; b freed on return

    with FakeTensorMode():
        x = torch.empty(1024, 1024)
        _, c = count_ops(f, x, track=(x,))
    mb = 1024 * 1024 * 4
    assert c.argument_bytes == mb
    assert c.peak_bytes == 3 * mb
    assert c.final_bytes == mb + 4


def test_the_attention_kernel_is_one_launch_with_its_own_work():
    """On fake tensors the wrapper calls the kernel's operator as on the
    card: one launch, the causal pairs' 3xTF32 flops, q, k, v read and o
    written; its plain version is not called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.attention import kernel as K

    b, h, s, d = 2, 4, 256, 64
    with FakeTensorMode():
        q, k, v = (torch.empty(b, h, s, d) for _ in range(3))
        before = K.flash_attention.launches
        out, c = count_ops(K.flash_attention, q, k, v)
        assert tuple(out.shape) == (b, h, s, d)
    assert K.flash_attention.launches == before      # nothing launched
    assert c.launches == {"attention": 1}
    assert c.flops["tf32x3"] == 4.0 * b * h * d * s * (s + 1) / 2
    assert c.flops["tf32x3"] == K.attention_flops((b, h, s, d), True)
    assert c.bytes == 4 * b * h * s * d * 4
    assert c.ops == 1


@pytest.mark.parametrize("remat,per_layer", [("nothing_saveable", 2),
                                             ("none", 1)])
def test_a_train_steps_launches_are_the_kernels(monkeypatch, remat,
                                                per_layer):
    """A qwen1.5 SMOKE step counted on fake tensors launches the kernel
    twice a layer under nothing_saveable (the remat recompute) and once
    without remat."""
    monkeypatch.setattr(dryrun, "ARCHS", dict(SMOKES))
    cfg = SMOKES["qwen1.5-0.5b"]
    c = dryrun.count_train_step("qwen1.5-0.5b", StepConfig(remat=remat),
                                4, 64)
    assert c.launches == {"attention": per_layer * cfg.n_layers}
    assert c.collective_bytes == {}
    assert c.peak_bytes > c.argument_bytes > 0
    assert not dist.is_initialized()


# =============================================================================
# The roofline
# =============================================================================
def test_the_roofline_terms_by_hand():
    hw = hwspec.H100_SXM
    c = OpCount(flops={"bf16": 4e12, "fp32": 1e11, "tf32x3": 3e11},
                product_flops=4.3e12, bytes=6.7e10,
                collective_bytes={"all-gather": 1e9, "all-reduce": 2e9},
                collective_counts={"all-gather": 3, "all-reduce": 4},
                collective_links={"nvlink": {"all-gather": 1e9},
                                  "net": {"all-reduce": 2e9}})
    rf = analysis.analyze_count(c, chips=256, model_flops=1e15)
    compute = 4e12 / 989e12 + 1e11 / 67e12 + 3e11 / (495e12 / 3)
    assert rf.compute_s == pytest.approx(compute, rel=1e-12)
    assert rf.memory_s == pytest.approx(6.7e10 / 3.35e12, rel=1e-12)
    coll = 1e9 * 1.0 / (25e9 * 18) + 2e9 * 2.0 / 50e9
    assert rf.collective_s == pytest.approx(coll, rel=1e-12)
    assert rf.collective_bytes == 1e9 + 2 * 2e9
    assert rf.flops == pytest.approx(4.4e12 * 256)
    assert rf.hbm_bytes == 6.7e10 * 256
    assert rf.dominant == "collective"
    assert rf.bound_time == rf.collective_s
    assert rf.useful_flops_ratio == pytest.approx(1e15 / (4.4e12 * 256))
    assert rf.xla_reported_flops == 4.3e12
    assert analysis.model_flops_train(10, 7) \
        == janalysis.model_flops_train(10, 7)
    assert analysis.model_flops_decode(10, 7) \
        == janalysis.model_flops_decode(10, 7)
    ours = rf.summary()
    theirs = janalysis.Roofline(
        flops=1.0, hbm_bytes=1.0, collective_bytes=1.0, chips=1,
        compute_s=1.0, memory_s=1.0, collective_s=1.0,
        collectives=janalysis.CollectiveStats({}, {})).summary()
    assert list(ours) == list(theirs)
    assert analysis._RING_FACTOR == janalysis._RING_FACTOR


# =============================================================================
# lower_cell against the JAX dry run
# =============================================================================
@pytest.fixture(scope="module")
def jax_dry():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_jax_dryrun.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port_dry():
    """The port's records of the same SMOKE cells, with their counts, the
    production mesh replaced by a 2x2 and a 1x1 fake mesh."""
    from repro_torch.launch import mesh as meshes

    saved = dryrun.ARCHS, dryrun.SHAPES, meshes.production_shape
    dryrun.ARCHS, dryrun.SHAPES = dict(SMOKES), SMALL
    out = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for mesh_name, shape in (("2x2", (2, 2)), ("1x1", (1, 1))):
                meshes.production_shape = (
                    lambda multi_pod=False, shape=shape:
                    (shape, ("data", "model")))
                for name in SMALL:
                    out[f"{mesh_name}/{name}"] = dryrun.count_cell(
                        SMOKE_ARCH, name, False)
                if mesh_name != "2x2":
                    continue
                with torch_211_gaps():
                    for arch in MOE_ARCHS:
                        for name in SMALL:
                            out[f"2x2/{arch}/{name}"] = dryrun.count_cell(
                                arch, name, False)
    finally:
        dryrun.ARCHS, dryrun.SHAPES, meshes.production_shape = saved
    return out


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k in ("memory",
                                                          "roofline")
            else None for k, v in d.items()}


def test_skipped_records_and_keys_equal_the_jax_ones(jax_dry, port_dry):
    skipped = [dryrun.lower_cell(arch, shape, multi, verbose=False)
               for arch in ARCHS for shape in SHAPES
               if not shape_applicable(JARCHS[arch], JSHAPES[shape])[0]
               for multi in (False, True)]
    assert skipped and skipped == jax_dry["skipped"]
    for cell, (rec, count) in port_dry.items():
        theirs = jax_dry["cells"][cell]
        assert rec["status"] == theirs["status"] == "ok"
        extra = {"dot_flops", "dense_dot_flops"}
        assert _keys(rec) == _keys({k: v for k, v in theirs.items()
                                    if k not in extra}), cell
        assert rec["chips"] == theirs["chips"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_smoke_cells_against_the_jax_dry_run(jax_dry, port_dry, cell):
    for mesh in ("1x1", "2x2"):
        rec, count = port_dry[f"{mesh}/{cell}"]
        theirs = jax_dry["cells"][f"{mesh}/{cell}"]
        assert rec["roofline"]["model_flops"] \
            == theirs["roofline"]["model_flops"]
        dense = sum(count.product_flops_by_op.get(op, 0.0)
                    for op in ("mm", "addmm"))
        if cell == "decode_32k":
            ours, ref = count.product_flops, theirs["dot_flops"]
        else:
            ours, ref = dense, theirs["dense_dot_flops"]
        if mesh == "1x1":
            assert ours == ref, (cell, ours, ref)
        else:
            dense_ref = theirs["dense_dot_flops"]
            lo, hi = MESH_BANDS[cell]
            assert lo <= dense / dense_ref <= hi, (cell, dense, dense_ref)
        # attention: the kernel's causal pairs (train, prefill), decode's
        # products over the cache
        if cell == "decode_32k":
            assert count.launches == {}
        else:
            assert count.launches["attention"] > 0
            assert count.flops["tf32x3"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert not dist.is_initialized()


def _products(count, cell, theirs):
    """The per-device products the JAX ones are held to: the dense
    layers' (``mm``, ``addmm``) in train and prefill, all in decode."""
    if cell == "decode_32k":
        return count.product_flops, theirs["dot_flops"]
    return (sum(count.product_flops_by_op.get(op, 0.0)
                for op in ("mm", "addmm")), theirs["dense_dot_flops"])


@pytest.mark.parametrize("arch,cell", list(MOE_BANDS),
                         ids=[f"{a}-{c}" for a, c in MOE_BANDS])
def test_moe_smoke_cells_against_the_jax_dry_run(jax_dry, port_dry, arch,
                                                 cell):
    """Counted under torch 2.11's DTensor gaps (the fixture): ok, the JAX
    record's ``model_flops``, the per-device products in their band, the
    peak above the arguments, collectives on the mesh."""
    rec, count = port_dry[f"2x2/{arch}/{cell}"]
    theirs = jax_dry["cells"][f"2x2/{arch}/{cell}"]
    assert rec["status"] == theirs["status"] == "ok"
    assert rec["roofline"]["model_flops"] \
        == theirs["roofline"]["model_flops"]
    ours, ref = _products(count, cell, theirs)
    lo, hi = MOE_BANDS[arch, cell]
    assert lo <= ours / ref <= hi, (arch, cell, ours, ref)
    if cell != "decode_32k":
        lo, hi = MOE_ALL_BANDS[arch, cell]
        ratio = count.product_flops / theirs["dot_flops"]
        assert lo <= ratio <= hi, (arch, cell, ratio)
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert sum(count.collective_bytes.values()) > 0
    assert (count.launches.get("attention", 0) > 0) == (
        arch == "llama4-scout-17b-a16e" and cell != "decode_32k")
    assert not dist.is_initialized()


@pytest.mark.parametrize("gaps", [False, True], ids=["2.13", "2.11"])
def test_the_moe_combine_is_counted_at_rank_0s_share(gaps):
    """``moe.combine_experts`` at the layouts a SMOKE MoE train cell gives
    it on the 2x2 mesh (the combine whole, the experts' outputs split by
    expert over ``model`` and by feature over ``data``): rank 0 multiplies
    its own experts and features, 2·g·t·(e/2)·c·(d/2) flops, under torch
    2.11's gaps as under 2.13.  The one ``einsum`` it replaced gathered
    every expert first, twice the flops (on 2.13; 2.11 refuses it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.moe import combine_experts

    g, t, e, c, d = 1, 64, 8, 21, 64
    with fake_mesh((2, 2), ("data", "model")) as mesh, FakeTensorMode(), \
            torch_211_gaps() if gaps else contextlib.nullcontext():
        comb = DTensor.from_local(torch.empty(g, t, e, c), mesh,
                                  [Replicate(), Replicate()],
                                  run_check=False)
        yout = DTensor.from_local(torch.empty(e // 2, g, c, d // 2), mesh,
                                  [Shard(3), Shard(0)], run_check=False)
        out, count = count_ops(lambda: combine_experts(comb, yout),
                               track=(comb, yout))
        assert tuple(out.shape) == (g, t, d)
        assert count.product_flops_by_op == {
            "bmm": 2.0 * g * t * (e // 2) * c * (d // 2)}
        if not gaps:
            _, old = count_ops(lambda: torch.einsum("gtec,egcd->gtd", comb,
                                                    yout), track=(comb, yout))
            assert old.product_flops == 2 * count.product_flops
    assert not dist.is_initialized()


def test_xlstm_decode_counts_under_torch_211s_gaps(monkeypatch):
    """xlstm-125m's decode (its read-out on local shards) counts on the
    2x2 fake mesh under the gaps, and a MoE train cell with the combine
    as one ``einsum`` (the code before) does not: the gaps are live."""
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import moe

    monkeypatch.setattr(dryrun, "ARCHS", dict(SMOKES))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(meshes, "production_shape",
                        lambda multi_pod=False: ((2, 2), ("data", "model")))
    with warnings.catch_warnings(), torch_211_gaps():
        warnings.simplefilter("ignore")
        rec, count = dryrun.count_cell("xlstm-125m", "decode_32k", False)
        assert rec["status"] == "ok" and count.product_flops > 0
        monkeypatch.setattr(moe, "combine_experts", lambda c, y: torch.einsum(
            "gtec,egcd->gtd", c, y))
        with pytest.raises(RuntimeError, match="flatten"):
            dryrun.count_cell("llama4-scout-17b-a16e", "train_4k", False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,cell,site", [
    ("qwen2.5-3b", "train_4k", "models/common.py:embed_lookup"),
    ("deepseek-v2-236b", "prefill_32k", "models/moe.py:moe_apply_dropless"),
])
def test_collectives_and_the_peak_by_call_site(monkeypatch, arch, cell,
                                               site):
    """On a 2x2 fake mesh the counts by call site add up to the totals
    (collective bytes and seconds, the peak's bytes) and name the site of
    the embedding table's gather or of the MoE's replicated tokens; the
    expected-load hook is put back after the count."""
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import moe

    monkeypatch.setattr(dryrun, "ARCHS", dict(SMOKES))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(meshes, "production_shape",
                        lambda multi_pod=False: ((2, 2), ("data", "model")))
    real = moe.group_sizes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec, count = dryrun.count_cell(arch, cell, False, sites=True)
    assert moe.group_sizes is real
    sites = rec["sites"]
    by_site = sum(b for links in count.collective_sites.values()
                  for by_op in links.values() for b in by_op.values())
    assert by_site == pytest.approx(sum(count.collective_bytes.values()),
                                    rel=1e-12)
    assert sum(sites["collective_s"].values()) == pytest.approx(
        rec["roofline"]["collective_s"], rel=1e-12)
    assert sum(sites["peak_bytes"].values()) == pytest.approx(
        rec["memory"]["peak_bytes"], rel=1e-12)
    assert sites["peak_bytes"]["arguments"] == count.argument_bytes
    assert sites["collective_bytes"][site] > 0
    if site.endswith("embed_lookup"):
        # the fp32 table (V, D) split on both axes, made whole by two
        # all-gathers (half the table, then all of it), once a microbatch
        v, d = SMOKES[arch].vocab_size, SMOKES[arch].d_model
        mb = dryrun.step_config_for(arch, cell).microbatches
        assert count.collective_sites[site] == {
            "nvlink": {"all-gather": mb * 1.5 * v * d * 4}}
        assert sites["collective_bytes"][site + " (backward)"] > 0
    # without sites, the same totals and no sites
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain, count0 = dryrun.count_cell(arch, cell, False)
    assert "sites" not in plain and count0.collective_sites == {}
    assert count0.collective_bytes == count.collective_bytes
    assert count0.peak_bytes == count.peak_bytes
