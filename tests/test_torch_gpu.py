"""Tests that need a CUDA card: the port's kernels against their plain
PyTorch versions on the card (the GEMM's wgmma path against float64 too,
and the path each call takes), the card evaluator and its gate, the fleet
and the daemon on the card, and serving (the model zoo's SMOKE archs, all
ten, on the card against the port on the CPU, attention at the models'
shapes, the engine, the online autotuner's timed waves and the serve CLI),
training, the sharded step, the dry run and step tuning, and the dry run's
cells that the card machine's torch (2.11) once refused.

This file imports no JAX, so that it runs where the card is and JAX is not:
``python -m pytest -m gpu tests/test_torch_gpu.py``.  Without a card every
test skips, decided at run time by the ``cuda`` fixture.

Tolerances, relative to max |plain|, are those of the JAX package's kernel
tests: matmul 2e-4, transpose exact, conv2d 1e-3, coulomb 5e-4, nbody 1e-3,
attention 2e-3; the sums run in another order (and rsqrt and exp are the
hardware's approximations).  The GEMM and attention take their products by
3xTF32 on the tensor cores; they are held to the same tolerances against
their fp32 oracles (TF32 off) at the registry's full sizes too.
"""
import dataclasses
import importlib
import math
import time

import numpy as np
import pytest
import torch

from repro_torch.core.evaluate import DeviceKernelEvaluator
from repro_torch.kernels.attention import kernel as A
from repro_torch.kernels import common
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.attention.space import AttentionInput
from repro_torch.kernels.conv2d.space import ConvInput
from repro_torch.kernels.coulomb.space import CoulombInput
from repro_torch.kernels.matmul import kernel as K
from repro_torch.kernels.matmul import space as S
from repro_torch.kernels.nbody.space import NBodyInput
from repro_torch.kernels.registry import BENCHMARKS
from repro_torch.kernels.transpose.space import TransposeInput

TOL = 2e-4


@pytest.fixture
def cuda():
    """The card; skips (at run time, never at import) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(m, n, k, device, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
            .to(device),
            torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
            .to(device))


def _kw(cfg):
    bm, bn, bk, order = cfg
    return dict(block_m=bm, block_n=bn, block_k=bk, loop_order=order)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (16, 4096, 4096),
                                   (1000, 1000, 1000), (100, 200, 300)])
@pytest.mark.parametrize("cfg", [(64, 64, 128, "mnk"), (512, 512, 1024, "nmk"),
                                 (128, 256, 256, "nmk")])
def test_cuda_kernel_matches_its_plain_version(cuda, shape, cfg):
    a, b = _inputs(*shape, cuda)
    before = K.matmul.launches
    out = K.matmul(a, b, **_kw(cfg))
    assert K.matmul.launches == before + 1
    ref = K.matmul_plain(a, b, **_kw(cfg))
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < TOL


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(K, "matmul_plain", refuse)
    a, b = _inputs(64, 64, 64, cuda)
    K.matmul(a, b)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_evaluator_times_on_the_card(cuda):
    bench = BENCHMARKS["matmul"]
    inp = bench.inputs["128"]
    ev = DeviceKernelEvaluator(S.make_space(inp), bench, inp, reps=3)
    assert ev.device.type == "cuda" and ev.hw.sms > 0
    cs = ev.profile(0)
    assert 0 < cs.runtime < 1.0


def _card_ms(before, after):
    torch.cuda.synchronize()
    return before.elapsed_time(after)


@pytest.mark.gpu
def test_a_gate_holds_the_card_until_the_host_opens_it(cuda):
    from repro_torch.core.evaluate import _Gate

    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    first.record()
    number = _Gate.queue(cuda)
    last.record()
    time.sleep(0.02)
    _Gate.open(number)
    assert 15.0 < _card_ms(first, last) < 45.0


@pytest.mark.gpu
def test_a_gate_never_opened_lets_the_card_go_after_its_timeout(cuda):
    from repro_torch.core.evaluate import _Gate

    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    first.record()
    number = _Gate.queue(cuda)
    last.record()
    waited = _card_ms(first, last)
    _Gate.open(number)
    assert 45.0 < waited < 100.0      # gate.cu's kTimeoutNs: 50 ms


@pytest.mark.gpu
def test_the_evaluator_times_the_card_not_a_slow_host(cuda):
    """A host path of 2 ms a launch (ten times a GEMM at 2048^3) stays out of
    the evaluator's timing windows: the gate holds the timed launches
    until all are queued."""
    bench = BENCHMARKS["matmul"]
    inp = bench.inputs["2048"]
    space = S.make_space(inp)
    idx = space.index_of({"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                          "LOOP_ORDER": "mnk", "ACC_F32": 0})
    fast = DeviceKernelEvaluator(space, bench, inp).measure(idx)

    def slow_run(cfg, *args):
        time.sleep(0.002)
        return bench.run(cfg, *args)

    slow_bench = dataclasses.replace(bench, run=slow_run)
    slow = DeviceKernelEvaluator(space, slow_bench, inp).measure(idx)
    assert slow < 1.2 * fast


@pytest.mark.gpu
def test_a_refused_launch_raises(cuda, monkeypatch):
    entry = K._entry()
    assert entry(None, None, None, None, 0, 1, 1, 64, 64, 64, 0, 1,
                 None) != 0
    # two splits need a workspace
    assert entry(None, None, None, None, 16, 16, 256, 64, 64, 128, 0, 2,
                 None) != 0
    monkeypatch.setattr(K, "_entry", lambda: (lambda *args: 1))
    a, b = _inputs(64, 64, 64, cuda)
    before = K.matmul.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K.matmul(a, b)
    assert K.matmul.launches == before


# --- the GEMM's 128 x 128 sub-tile on wgmma and TMA ---------------------------

from _torch_matmul_paths import WGMMA_CASES, case_id  # noqa: E402


def _unaligned(x):
    """A contiguous copy of ``x`` whose base lies 4 bytes past 16."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
def test_the_gemm_holds_hgmma_and_hmma_instructions(cuda):
    """wgmma (HGMMA) in the 128 x 128 sub-tile's kernel, mma.sync (HMMA) in
    the 64-wide and unaligned sub-tiles' kernels."""
    common.load_library(K.SOURCE)
    assert common.count_sass(K.SOURCE, "HGMMA", "matmul_wgmma_kernel") > 0
    for sub in ("ILi64ELi64E", "ILi64ELi128E", "ILi128ELi64E", "ILi128ELi128E"):
        assert common.count_sass(K.SOURCE, "HMMA",
                                 "matmul_tf32x3_kernel" + sub) > 0, sub


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", [
    ((2048, 2048, 2048), (128, 128, 128, "mnk")),
    ((2048, 2048, 2048), (256, 256, 128, "nmk")),     # 4 splits
    ((2048, 2048, 2048), (512, 512, 1024, "mnk")),    # 2 splits
    ((1000, 1000, 1000), (128, 128, 128, "nmk")),     # ragged, aligned
], ids=lambda x: "x".join(map(str, x)))
def test_the_wgmma_path_meets_the_float64_reference(cuda, shape, cfg):
    a, b = _inputs(*shape, cuda)
    before, wgmma = K.matmul.launches, K.matmul.wgmma_launches
    out = K.matmul(a, b, **_kw(cfg))
    torch.cuda.synchronize()
    assert K.matmul.launches == before + 1
    assert K.matmul.wgmma_launches == wgmma + 1
    ref = a.double() @ b.double()
    assert float((out.double() - ref).abs().max() / ref.abs().max()) < TOL
    # the plain version describes the path: the sums' order alone differs,
    # 1.6e-5 of max |C| at K = 2048 (each side's own from float64), where
    # one TF32 pass is 2.8e-4 off
    plain = K.matmul_plain(a, b, **_kw(cfg))
    assert float((out - plain).abs().max() / plain.abs().max()) < 5e-5
    assert torch.equal(K.matmul(a, b, **_kw(cfg)), out)    # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES, ids=case_id)
def test_the_c_entry_takes_the_path_its_rule_gives(cuda, case):
    (m, n, k), (bm, bn, bk), aligned, takes = case
    a, b = _inputs(m, n, k, cuda)
    if not aligned:
        a, b = _unaligned(a), _unaligned(b)
    before, wgmma = K.matmul.launches, K.matmul.wgmma_launches
    out = K.matmul(a, b, **_kw((bm, bn, bk, "mnk")))
    torch.cuda.synchronize()
    assert K.matmul.launches == before + 1
    assert K.matmul.wgmma_launches == wgmma + int(takes)
    ref = K.matmul_plain(a, b, **_kw((bm, bn, bk, "mnk")))
    assert float((out - ref).abs().max() / ref.abs().max()) < TOL


# The four other paper kernels: (kernel, tolerance, inputs, configs).  Each
# input is a ragged size or a registry input; the configs take the smallest
# and largest tiles and each value of every parameter that changes the code
# path.
PAPER = {
    "transpose": (0.0, [TransposeInput(200, 264), TransposeInput(96, 512),
                        TransposeInput(8192, 8192)],
                  [(8, 8, 0), (1024, 1024, 1), (32, 256, 1), (256, 32, 0)]),
    "conv2d": (1e-3, [ConvInput(1000, 1500, 5), ConvInput(37, 300, 3),
                      ConvInput(4096, 4096, 5)],
               [(8, 128, 0, 0, 1), (512, 1024, 1, 1, 4), (32, 256, 1, 0, 2),
                (128, 512, 0, 1, 1)]),
    "coulomb": (5e-4, [CoulombInput(40, 5000), CoulombInput(33, 100),
                       CoulombInput(256, 256)],
                [(1, 4, 64, 4, 0), (64, 8, 1024, 256, 1), (2, 64, 1024, 16, 0),
                 (4, 32, 128, 64, 1), (8, 64, 256, 256, 0),
                 (16, 16, 512, 64, 0), (32, 16, 64, 4, 1)]),
    "nbody": (1e-3, [NBodyInput(10000), NBodyInput(200), NBodyInput(16384)],
              [(8, 32, 1, 0), (1024, 2048, 4, 1), (64, 256, 2, 0),
               (256, 128, 1, 1)]),
}
PAPER_CASES = [(k, i) for k, (_, inputs, _) in PAPER.items()
               for i in range(len(inputs))]


def _plain(kernel):
    return getattr(importlib.import_module(
        f"repro_torch.kernels.{kernel}.kernel"), f"{kernel}_plain")


def _wrapper(kernel):
    return getattr(importlib.import_module(
        f"repro_torch.kernels.{kernel}.kernel"), kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,which", PAPER_CASES,
                         ids=[f"{k}-{i}" for k, i in PAPER_CASES])
def test_paper_kernel_matches_its_plain_version(cuda, kernel, which):
    tol, inputs, configs = PAPER[kernel]
    bench = BENCHMARKS[kernel]
    names = list(bench.make_space().parameters)
    args = bench.make_args(inputs[which], np.random.default_rng(0), cuda)
    ref = _plain(kernel)(*args)
    wrapper = _wrapper(kernel)
    for values in configs:
        cfg = {p.name: v for p, v in zip(names, values)}
        before = wrapper.launches
        out = bench.run(cfg, *args)
        assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(out.isfinite().all())
        err = float((out - ref).abs().max() / ref.abs().max())
        if tol == 0.0:
            assert torch.equal(out, ref), cfg
        else:
            assert err < tol, (cfg, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(PAPER))
def test_paper_kernels_never_reach_the_plain_version(cuda, kernel,
                                                     monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    mod = importlib.import_module(f"repro_torch.kernels.{kernel}.kernel")
    monkeypatch.setattr(mod, f"{kernel}_plain", refuse)
    bench = BENCHMARKS[kernel]
    args = bench.make_args(PAPER[kernel][1][1], np.random.default_rng(0),
                           cuda)
    bench.run(bench.make_space()[0], *args)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(PAPER))
def test_card_evaluator_times_each_paper_kernel(cuda, kernel):
    bench = BENCHMARKS[kernel]
    inp = PAPER[kernel][1][1]
    ev = DeviceKernelEvaluator(bench.make_space(), bench, inp, reps=3)
    cs = ev.profile(len(ev.space) - 1)
    assert 0 < cs.runtime < 1.0


# Flash attention: the registry input, a ragged one at each head dimension,
# and one query; configurations with the smallest and largest tiles and each
# value of KEEP_P and Q_PREFETCH, as (BLOCK_Q, BLOCK_K, KEEP_P, Q_PREFETCH).
ATTENTION_TOL = 2e-3
ATTENTION_SHAPES = [(4, 16, 4096, 128), (2, 3, 1000, 64), (1, 2, 200, 128),
                    (1, 1, 1, 64), (1, 2, 777, 128)]
ATTENTION_CONFIGS = [(128, 128, 0, 1), (1024, 1024, 1, 2), (256, 512, 1, 1),
                     (512, 256, 0, 2), (64, 64, 1, 2)]


def _attention_args(shape, device):
    return BENCHMARKS["attention"].make_args(AttentionInput(*shape),
                                             np.random.default_rng(0), device)


def _attention_kw(cfg):
    bq, bk, keep_p, prefetch = cfg
    return dict(block_q=bq, block_k=bk, keep_p=keep_p, q_prefetch=prefetch)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_matches_its_plain_version(cuda, shape, causal):
    q, k, v = _attention_args(shape, cuda)
    ref = A.flash_attention_plain(q, k, v, causal=causal)
    for cfg in ATTENTION_CONFIGS:
        before = A.flash_attention.launches
        out = A.flash_attention(q, k, v, causal=causal, **_attention_kw(cfg))
        assert A.flash_attention.launches == before + 1
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(out.isfinite().all())
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err < ATTENTION_TOL, (cfg, err)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ATTENTION_CONFIGS[:2])
def test_attention_reads_nothing_past_the_last_row(cuda, cfg):
    """q, k and v end where a NaN-filled buffer goes on: a row read past S
    of the last head would poison the output."""
    shape = (1, 2, 1000, 64)
    n = int(np.prod(shape))
    tensors = []
    for t in _attention_args(shape, cuda):
        buf = torch.full((n + 64 * 64,), float("nan"), device=cuda)
        buf[:n] = t.reshape(-1)
        tensors.append(buf[:n].view(shape))
    out = A.flash_attention(*tensors, **_attention_kw(cfg))
    ref = A.flash_attention_plain(*tensors)
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    assert float((out - ref).abs().max() / ref.abs().max()) < ATTENTION_TOL


@pytest.mark.gpu
def test_attention_never_reaches_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(A, "flash_attention_plain", refuse)
    A.flash_attention(*_attention_args((1, 2, 128, 64), cuda))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_a_refused_attention_launch_raises(cuda, monkeypatch):
    entry = A._entry()
    assert entry(None, None, None, None, 1, 64, 64, 64, 96, 64, 1, 1, 1,
                 1.0, None) != 0
    # a head dim that is not compiled (the wrapper pads it), and a V head
    # dim that is not compiled beside its D
    assert entry(None, None, None, None, 1, 64, 24, 24, 64, 64, 1, 1, 1,
                 1.0, None) != 0
    assert entry(None, None, None, None, 1, 64, 128, 64, 64, 64, 1, 1, 1,
                 1.0, None) != 0
    monkeypatch.setattr(A, "_entry", lambda: (lambda *args: 1))
    before = A.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        A.flash_attention(*_attention_args((1, 1, 64, 64), cuda))
    assert A.flash_attention.launches == before


# every compiled head dim, and padded ones between and below them
ATTENTION_HEAD_DIMS = list(A.HEAD_DIMS) + [1, 8, 24, 48, 96, 160, 200, 248]


@pytest.mark.gpu
@pytest.mark.parametrize("d", ATTENTION_HEAD_DIMS)
def test_attention_takes_every_head_dim(cuda, d):
    """Every configuration of the space launches at every compiled D (the
    shared tiles and accumulators fit), and a padded D matches the plain
    version at the caller's D and scale."""
    q, k, v = _attention_args((1, 3, 300, d), cuda)
    ref = A.flash_attention_plain(q, k, v)
    space = BENCHMARKS["attention"].make_space()
    configs = (ATTENTION_CONFIGS if d not in A.HEAD_DIMS
               else [tuple(c.values()) for c in space])
    for cfg in configs:
        out = A.flash_attention(q, k, v, **_attention_kw(cfg))
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(out.isfinite().all())
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err < ATTENTION_TOL, (cfg, err)


# DeepSeek-V2's latent attention: qk 192, V 128 (the split instance), at a
# small S and at the benchmark cell's input (one 2048-token chunk of the
# 16 heads an 8-way tensor-parallel card holds); against float64, within
# the cell's kernel_rel_err limit
MLA_SHAPES = [(1, 2, 200, 192, 128), (1, 16, 2048, 192, 128)]
MLA_TOL = 2e-5


def _softmax_v64(q, k, v, causal=True):
    """softmax(q kᵀ / √D) v in float64, one batch row at a time."""
    out = torch.empty(v.shape, dtype=torch.float64, device=v.device)
    s = q.shape[2]
    later = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    for i in range(q.shape[0]):
        sc = q[i].double() @ k[i].double().transpose(-1, -2) \
            / q.shape[-1] ** 0.5
        if causal:
            sc = sc.masked_fill(later, float("-inf"))
        out[i] = torch.softmax(sc, dim=-1) @ v[i].double()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MLA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mla_attention_at_every_configuration_against_float64(cuda, shape,
                                                              monkeypatch):
    """Every configuration of the space launches the (192, 128) instance,
    V unpadded, each launch counted as a split-V launch, and meets softmax
    V in float64; the plain version never runs."""
    monkeypatch.setattr(A, "flash_attention_plain", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("plain version on the card")))
    inp = AttentionInput(*shape[:4], v_head_dim=shape[4])
    q, k, v = BENCHMARKS["attention"].make_args(
        inp, np.random.default_rng(1), cuda)
    assert v.shape[-1] == 128
    for causal in ((True, False) if shape[2] < 1000 else (True,)):
        ref = _softmax_v64(q, k, v, causal)
        for cfg in BENCHMARKS["attention"].make_space():
            launches = A.flash_attention.launches
            split = A.flash_attention.split_v_launches
            out = A.flash_attention(q, k, v, causal=causal,
                                    **_attention_kw(tuple(cfg.values())))
            torch.cuda.synchronize()
            assert A.flash_attention.launches == launches + 1
            assert A.flash_attention.split_v_launches == split + 1
            assert out.shape == v.shape
            err = float((out.double() - ref).abs().max() / ref.abs().max())
            assert err < MLA_TOL, (cfg, causal, err)


@pytest.mark.gpu
def test_mla_attention_names_its_instance_in_the_device_trace(cuda):
    from torch.profiler import ProfilerActivity, profile

    q, k, v = BENCHMARKS["attention"].make_args(
        AttentionInput(1, 2, 256, 192, v_head_dim=128),
        np.random.default_rng(0), cuda)
    A.flash_attention(q, k, v)                       # built and warm
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        A.flash_attention(q, k, v)
        A.flash_attention(q, k, v[..., :100].contiguous())    # padded to 128
        A.flash_attention(q, k, torch.nn.functional.pad(v, (0, 64)))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "flash_tf32x3_kernel" in e.name]
    assert sum("flash_tf32x3_kernel<192, 128," in n for n in names) == 2
    assert sum("flash_tf32x3_kernel<192, 192," in n for n in names) == 1


@pytest.mark.gpu
def test_mla_layer_at_deepseek_v2_widths_meets_the_reference(cuda):
    """One MLA layer at DeepSeek-V2's published widths (d_model 5120, the
    16 heads of an 8-way tensor-parallel card, kv_lora_rank 512, nope 128,
    rope 64, V 128) on a 2048-token prompt, through ``mla_apply`` on the
    kernel, against ``tests/_torch_mla_reference.py`` in float32 with TF32
    off: within ``MLA_LAYER_TOL`` of max |y|, which the reference in TF32
    (the control) misses."""
    import _torch_mla_reference as R
    from repro_torch.models import attention as MA
    from repro_torch.models.common import init_params

    acfg = MA.AttnConfig(d_model=5120, n_heads=16, n_kv_heads=16,
                         head_dim=128, kv_lora_rank=512, qk_rope_dim=64,
                         v_head_dim=128)
    g = torch.Generator(device=cuda).manual_seed(7)
    params = init_params(MA.mla_defs(acfg), g, device=cuda)
    x = torch.randn((1, 2048, 5120), generator=g, device=cuda)
    launches = A.flash_attention.launches
    split = A.flash_attention.split_v_launches
    y, _ = MA.mla_apply(params, acfg, x)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == launches + 1
    assert A.flash_attention.split_v_launches == split + 1
    kw = dict(n_heads=16, nope_dim=128, rope_dim=64, v_dim=128)
    ref = R.mla_prefill(params, x, **kw)
    control = R.mla_prefill(params, x, tf32=True, **kw)
    err = _rel_t(y, ref)
    err_control = _rel_t(control, ref)
    assert err < MLA_LAYER_TOL < err_control, (err, err_control)


@pytest.mark.gpu
def test_card_evaluator_times_attention(cuda):
    bench = BENCHMARKS["attention"]
    ev = DeviceKernelEvaluator(bench.make_space(), bench,
                               AttentionInput(1, 2, 512, 64), reps=3)
    cs = ev.profile(len(ev.space) - 1)
    assert 0 < cs.runtime < 1.0


# --- the tensor-core redesign: 3xTF32 products, split-K, unaligned rows -----

# (shape, configs): 16x4096x4096 at BLOCK_K 128 and 1024 (many splits and
# few) and M = 16 at BLOCK_M 64; 2048^3; rows whose K and N are not
# multiples of 4
GEMM_ORACLE_CASES = [
    ((16, 4096, 4096), [(64, 64, 128, "mnk"), (512, 512, 1024, "nmk"),
                        (64, 128, 1024, "mnk"), (128, 256, 128, "nmk")]),
    ((2048, 2048, 2048), [(128, 128, 128, "mnk"), (64, 64, 256, "nmk"),
                          (512, 512, 1024, "mnk")]),
    ((1001, 1003, 999), [(64, 64, 128, "mnk"), (256, 128, 512, "nmk"),
                         (512, 512, 1024, "mnk")]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(GEMM_ORACLE_CASES)),
                         ids=["x".join(map(str, c[0]))
                              for c in GEMM_ORACLE_CASES])
def test_gemm_meets_its_fp32_oracle(cuda, case):
    shape, configs = GEMM_ORACLE_CASES[case]
    a, b = _inputs(*shape, cuda)
    oracle = torch.matmul(a, b)             # TF32 off (the fixture)
    for cfg in configs:
        out = K.matmul(a, b, **_kw(cfg))
        ref = K.matmul_plain(a, b, **_kw(cfg))
        torch.cuda.synchronize()
        scale = float(oracle.abs().max())
        assert float((out - oracle).abs().max()) / scale < TOL, cfg
        assert float((out - ref).abs().max()) / scale < TOL, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [(64, 64, 128, "mnk"), (512, 512, 1024, "nmk"),
                                 (128, 128, 128, "mnk")])
def test_gemm_gives_the_same_bits_twice(cuda, cfg):
    """Split-K partials are added in a fixed order: no run-to-run noise."""
    a, b = _inputs(16, 4096, 4096, cuda)
    bm, bn, bk, _ = cfg
    splits = K.split_count(16, 4096, 4096, bm, bn, bk, K.sm_count(a.device))
    assert splits > 1
    first = K.matmul(a, b, **_kw(cfg))
    second = K.matmul(a, b, **_kw(cfg))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_gemm_takes_unaligned_storage_on_the_card(cuda, monkeypatch):
    """Operands that start 4 bytes past a 16-byte boundary take the 4-byte
    copies inside the kernel, never the plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    a, b = _inputs(100, 128, 256, cuda)
    oracle = torch.matmul(a, b)
    bufs = [torch.empty(t.numel() + 1, device=cuda) for t in (a, b)]
    a1 = bufs[0][1:].view(a.shape).copy_(a)
    b1 = bufs[1][1:].view(b.shape).copy_(b)
    assert a1.data_ptr() % 16 and b1.data_ptr() % 16
    monkeypatch.setattr(K, "matmul_plain", refuse)
    out = K.matmul(a1, b1, block_m=64, block_n=64, block_k=128)
    torch.cuda.synchronize()
    assert float((out - oracle).abs().max() / oracle.abs().max()) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 16, 4096, 128), (2, 3, 1000, 64),
                                   (1, 2, 777, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_meets_its_fp32_oracle(cuda, shape):
    q, k, v = _attention_args(shape, cuda)
    oracle = attention_ref(q, k, v)          # TF32 off (the fixture)
    scale = float(oracle.abs().max())
    for cfg in ATTENTION_CONFIGS:
        out = A.flash_attention(q, k, v, **_attention_kw(cfg))
        torch.cuda.synchronize()
        assert float((out - oracle).abs().max()) / scale < ATTENTION_TOL, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["matmul.cu", "attention.cu"])
def test_tensor_core_kernels_hold_hmma_instructions(cuda, source):
    common.load_library(source)
    assert common.count_sass(source, "HMMA") > 0


# --- nbody and conv2d redesigned: the j-split, ragged rows, the halo ring -----

from repro_torch.kernels.conv2d import kernel as CV  # noqa: E402
from repro_torch.kernels.nbody import kernel as NB   # noqa: E402

# (N, configs as (BLOCK_I, BLOCK_J, J_UNROLL)): BLOCK_I 8 and 1024, the
# j-split largest (BLOCK_J 32 at N = 16384) and runs a few tiles long
NBODY_SPLIT_CASES = [(n, cfg) for n in (200, 10000, 16384)
                     for cfg in ((8, 32, 4), (8, 2048, 1), (1024, 32, 2),
                                 (1024, 2048, 4), (128, 256, 1))]


def _bodies(n, device):
    return BENCHMARKS["nbody"].make_args(NBodyInput(n),
                                         np.random.default_rng(0), device)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n,cfg", NBODY_SPLIT_CASES,
                         ids=[f"{n}-{'-'.join(map(str, c))}"
                              for n, c in NBODY_SPLIT_CASES])
def test_nbody_split_matches_its_plain_version(cuda, n, cfg):
    bi, bj, unroll = cfg
    bodies = _bodies(n, cuda)
    splits = NB.split_count(n, bi, bj, common.sm_count(cuda))
    if (n, bi, bj) == (16384, 1024, 32):
        assert splits > 1                  # the card is filled by splitting
    ref = NB.nbody_plain(bodies)
    before = NB.nbody.launches
    out = NB.nbody(bodies, block_i=bi, block_j=bj, j_unroll=unroll)
    assert NB.nbody.launches == before + 1
    torch.cuda.synchronize()
    assert bool(out.isfinite().all()) and bool((out[:, 3] == 0).all())
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < 1e-3, (splits, err)


# (H, W, F) and configs as (BY, BX, UNROLL_TAPS, FILTER_SMEM, DMA_DEPTH):
# rows whose W % 4 != 0 (4-byte copies), F = 1, 7 and 9 unrolled and looped,
# each DMA_DEPTH with tiles of one sub-tile and of many
CONV_CASES = [(1000, 1501, 5), (37, 301, 3), (300, 260, 1), (515, 700, 7),
              (200, 333, 9)]
CONV_CONFIGS = [(32, 128, 1, 1, 1), (128, 256, 1, 0, 2), (512, 1024, 1, 1, 4),
                (16, 512, 0, 1, 2), (64, 128, 0, 0, 4), (256, 384, 0, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CONV_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv2d_ragged_rows_taps_and_depths(cuda, shape):
    img, flt = BENCHMARKS["conv2d"].make_args(ConvInput(*shape),
                                              np.random.default_rng(0), cuda)
    ref = CV.conv2d_plain(img, flt)
    for by, bx, unroll, fsmem, depth in CONV_CONFIGS:
        unroll = unroll if shape[2] in CV.UNROLLED_F else 0
        out = CV.conv2d(img, flt, by=by, bx=bx, unroll_taps=unroll,
                        filter_smem=fsmem, dma_depth=depth)
        torch.cuda.synchronize()
        assert bool(out.isfinite().all())
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err < 1e-3, ((by, bx, unroll, fsmem, depth), err)


@pytest.mark.gpu
@pytest.mark.parametrize("f", range(9, CV.MAX_F + 1, 2))
def test_conv2d_takes_every_odd_filter_size_unrolled(cuda, f):
    """UNROLL_TAPS = 1 at each odd F from 9 to MAX_F, each filter placement
    and the deepest ring: register-blocked taps where they are compiled,
    the looped kernel above, which gives UNROLL_TAPS = 0's bits."""
    img, flt = BENCHMARKS["conv2d"].make_args(ConvInput(300, 517, f),
                                              np.random.default_rng(0), cuda)
    ref = CV.conv2d_plain(img, flt)
    for fsmem in (0, 1):
        out = CV.conv2d(img, flt, by=64, bx=256, unroll_taps=1,
                        filter_smem=fsmem, dma_depth=4)
        looped = CV.conv2d(img, flt, by=64, bx=256, unroll_taps=0,
                           filter_smem=fsmem, dma_depth=4)
        torch.cuda.synchronize()
        assert bool(out.isfinite().all())
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err < 1e-3, (fsmem, err)
        if CV.taps_kernel(f, 1) == 0:
            assert torch.equal(out, looped)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [(32, 128, 1, 1, 1), (128, 256, 0, 0, 4)])
def test_conv2d_reads_nothing_outside_the_image(cuda, cfg):
    """The image lies between NaN-filled rows of one buffer, starting 4
    bytes past a 16-byte boundary: a halo copy that read outside the image
    instead of zero-filling would poison the output."""
    h, w = 300, 517
    img, flt = BENCHMARKS["conv2d"].make_args(ConvInput(h, w, 5),
                                              np.random.default_rng(0), cuda)
    buf = torch.full(((h + 8) * w + 1,), float("nan"), device=cuda)
    inner = buf[4 * w + 1:4 * w + 1 + h * w].view(h, w)
    inner.copy_(img)
    assert inner.data_ptr() % 16
    by, bx, unroll, fsmem, depth = cfg
    out = CV.conv2d(inner, flt, by=by, bx=bx, unroll_taps=unroll,
                    filter_smem=fsmem, dma_depth=depth)
    ref = CV.conv2d_plain(img, flt)
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,cfg", [
    ("nbody", (1024, 32, 4, 0)), ("nbody", (8, 2048, 1, 0)),
    ("nbody", (128, 256, 2, 0)),
    ("conv2d", (32, 128, 1, 1, 1)), ("conv2d", (512, 1024, 0, 0, 4)),
    ("conv2d", (128, 256, 1, 0, 2))])
def test_nbody_and_conv2d_give_the_same_bits_twice(cuda, kernel, cfg):
    bench = BENCHMARKS[kernel]
    inp = bench.default_input
    args = bench.make_args(inp, np.random.default_rng(0), cuda)
    config = {p.name: v for p, v in zip(bench.make_space().parameters, cfg)}
    first = bench.run(config, *args)
    second = bench.run(config, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 3, 32])
def test_nbody_sum_splits_adds_the_slices_in_order(cuda, splits):
    """The j-split's second kernel alone: slice 0 + slice 1 + ... in that
    order, bit for bit, column 3 zero."""
    n = 1000
    gen = torch.Generator(device=cuda).manual_seed(splits)
    partial = torch.randn((splits, n, 4), generator=gen, device=cuda)
    out = torch.empty((n, 4), device=cuda)
    assert common.launch(NB._sum_entry(), cuda, partial.data_ptr(),
                         out.data_ptr(), n, splits) == 0
    ref = partial[0].clone()
    for s in range(1, splits):
        ref += partial[s]
    ref[:, 3] = 0
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert common.launch(NB._sum_entry(), cuda, partial.data_ptr(),
                         out.data_ptr(), n, 0) != 0


@pytest.mark.gpu
def test_refused_nbody_and_conv2d_launches_raise(cuda, monkeypatch):
    nbody_entry, conv_entry = NB._entry(), CV._entry()
    # two runs of the j range need a workspace; BLOCK_I 24 is not a power
    # of two; one tile cannot make two runs
    assert nbody_entry(None, None, None, 64, 64, 32, 1, 2, 1e-3, None) != 0
    assert nbody_entry(None, None, None, 64, 24, 32, 1, 1, 1e-3, None) != 0
    assert nbody_entry(None, None, None, 64, 64, 64, 1, 2, 1e-3, None) != 0
    # DMA_DEPTH 5 and 0
    for depth in (5, 0):
        assert conv_entry(None, None, None, 8, 8, 5, 32, 128, 1, 1, depth,
                          None) != 0
    monkeypatch.setattr(NB, "_entry", lambda: (lambda *args: 1))
    monkeypatch.setattr(CV, "_entry", lambda: (lambda *args: 1))
    before = (NB.nbody.launches, CV.conv2d.launches)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        NB.nbody(_bodies(64, cuda))
    img = torch.zeros((8, 8), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        CV.conv2d(img, torch.zeros((5, 5), device=cuda))
    assert (NB.nbody.launches, CV.conv2d.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_nbody_rsqrt_is_a_lone_mufu(cuda, unroll):
    """rsqrt.approx.ftz compiles to MUFU.RSQ with no denormal fix-up: the
    one-lane kernel's inner loop holds 4 bodies x J_UNROLL pairs of 6 FFMA,
    3 FMUL, 3 FADD and one MUFU.RSQ, and no FSETP."""
    common.load_library(NB.SOURCE)
    fn = f"nbody_f32_kernelILi{unroll}ELb1E"

    def count(op):
        return common.count_sass(NB.SOURCE, op, function=fn)

    pairs = NB.BODIES_PER_THREAD * unroll
    assert count("MUFU.RSQ") == pairs
    assert count("FFMA") == 6 * pairs and count("FMUL") == 3 * pairs
    assert count("FSETP") == 0


# --- the fleet measuring on the card -----------------------------------------

@pytest.mark.gpu
def test_a_one_lane_fleet_measures_on_the_card(cuda):
    """A subprocess lane on cuda:0 measures two small jobs: the lane reports
    this card and launches of both kernels, every test is finite, and the
    second round warm-starts from the first's artifacts."""
    from repro_torch.core import hwspec
    from repro_torch.fleet import (FleetTuner, SubprocessWorkerPool,
                                   job_from_registry)
    from repro_torch.tuning import ConfigStore

    hw = hwspec.detect(0)
    pool = SubprocessWorkerPool(devices=["cuda:0"])
    store = ConfigStore()
    try:
        cold = FleetTuner([job_from_registry(k, i, hw, budget=4,
                                             searcher="random",
                                             device="cuda:0")
                           for k, i in (("matmul", "128"),
                                        ("nbody", "16k"))],
                          pool, store=store).run()
        warm = FleetTuner([job_from_registry("matmul", "2048", None,
                                             budget=3, device="cuda:0")],
                          pool, store=store).run()
        lanes = pool.lane_info()
    finally:
        pool.close()
    for r in cold.results + warm.results:
        assert r.failures == 0 and np.isfinite(r.best_runtime)
        assert all(0 < rt < 1.0 for _, rt in r.history)
    assert warm.results[0].warm_started
    assert lanes[0]["device_name"] == torch.cuda.get_device_name(0)
    assert lanes[0]["launches"]["matmul"] > 0
    assert lanes[0]["launches"]["nbody"] > 0


@pytest.mark.gpu
def test_a_measuring_pool_has_one_lane_a_card(cuda):
    from repro_torch.fleet import SubprocessWorkerPool

    with pytest.raises(ValueError):
        SubprocessWorkerPool(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        SubprocessWorkerPool(
            devices=[f"cuda:{torch.cuda.device_count()}"])


# --- the tuning service measuring on the card --------------------------------

@pytest.fixture
def card_daemon(cuda):
    """A daemon over one subprocess lane on cuda:0, driven in process."""
    from repro_torch.fleet import SubprocessWorkerPool
    from repro_torch.service import TuningDaemon
    from repro_torch.tuning import ConfigStore

    pool = SubprocessWorkerPool(devices=["cuda:0"])
    d = TuningDaemon(pool, ConfigStore(), default_trial_budget=4)
    d.tuner.begin()
    yield d
    pool.close()


def _card_submit(d, kernel, inp, hw):
    from repro_torch.service import validate_request

    return d.handle(validate_request(dict(
        op="submit", kind="kernel", tenant="t", kernel=kernel, input=inp,
        hardware=hw)))


def _card_drive(d, rid, seconds=300):
    import time

    deadline = time.time() + seconds
    while d._records[rid].state not in ("done", "cancelled"):
        assert time.time() < deadline, "the request did not resolve"
        d._admit_pending()
        d.tuner.step(max_wait=0.05)
        d._meter()


@pytest.mark.gpu
def test_a_daemon_measures_a_kernel_request_on_the_card(card_daemon):
    from repro_torch.core import hwspec

    d = card_daemon
    hw = hwspec.hardware_key(hwspec.detect(0))
    assert [(dev, hwspec.hardware_key(s)) for dev, s in d.cards] == \
        [("cuda:0", hw)]
    assert d.provenance == "card" and d.store.provenance == "card"
    r = _card_submit(d, "conv2d", "4096", hw)
    rec = d._records[r["request_id"]]
    assert rec.job.measured and rec.job.device == "cuda:0"
    _card_drive(d, rec.rid)
    res = d.handle({"op": "result", "request_id": rec.rid})
    assert res["ok"] and res["trials"] == 4 and res["source"] == "tuned"
    assert 0 < res["runtime"] < 1.0
    lane = d.pool.lane_info()[0]
    assert lane["device_name"] == torch.cuda.get_device_name(0)
    assert lane["launches"]["conv2d"] > 0
    assert d.tenants.get("t").spent_s > 0
    again = _card_submit(d, "conv2d", "4096", hw)
    assert again["state"] == "done" and again["trials"] == 0
    assert again["source"] == "store"
    assert d.pool.lane_info()[0]["launches"] == lane["launches"]


@pytest.mark.gpu
def test_a_daemon_refuses_a_card_it_does_not_have(card_daemon):
    from repro_torch.core import hwspec

    d = card_daemon
    other = "h100_pcie" if hwspec.detect(0).name == "h100_sxm" \
        else "h100_sxm"
    r = _card_submit(d, "nbody", "16k", other)
    assert not r["ok"] and "no card of" in r["error"]
    assert d._records == {}
    for _ in range(3):
        d._admit_pending()
        assert not d.tuner.step(max_wait=0.05)
    assert all(n == 0 for n in d.pool.lane_info()[0]["launches"].values())


# =============================================================================
# Serving on the card: the model zoo's transformer families, prefill
# attention on the kernel, the engine, the online autotuner's backend, the
# serve CLI
# =============================================================================
SMOKE_ARCHS = ["qwen1.5-0.5b", "qwen2.5-3b", "gemma-2b", "command-r-plus-104b",
               "llama4-scout-17b-a16e", "deepseek-v2-236b", "internvl2-76b",
               "zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]
MODEL_TOL = 1e-4     # fp32 SMOKE models, card against CPU: the sums' order
# one MLA layer at DeepSeek-V2's widths, card against the float32
# reference with TF32 off: the sums' order over 5120 and 512 terms (read
# 1.0-1.3e-6 on an H100; the reference in TF32 reads 5.6e-4)
MLA_LAYER_TOL = 2e-5


def _prefill_launches(cfg) -> int:
    """Attention kernel launches a prefill: one a GQA or MLA layer (the
    recurrent layers have none), one a Zamba2 superblock (its shared
    block), and the encoder's and decoder's self-attention a layer each."""
    if cfg.xlstm:
        return 0
    if cfg.mamba_per_attn:
        return cfg.n_layers // cfg.mamba_per_attn
    if cfg.enc_layers:
        return cfg.enc_layers + cfg.dec_layers
    return cfg.n_layers


def _rel_t(out, ref) -> float:
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_each_smoke_arch_on_the_card_matches_the_port_on_the_cpu(
        cuda, arch, monkeypatch):
    """Prefill logits and 4 decode steps (both fed the CPU's greedy
    tokens), one parameter set moved to the card; on the card the prefill
    attention never takes the plain version."""
    from repro_torch.configs import SMOKES
    from repro_torch.models.registry import build_model

    cfg = SMOKES[arch]
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(2, 23)).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
    if cfg.frontend == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
    ref, ref_cache = model.prefill(cpu_params, batch, 40)
    card_params = model.init(torch.Generator().manual_seed(2), device="cpu")
    card_params.to(cuda)
    monkeypatch.setattr(A, "flash_attention_plain", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("plain version on the card")))
    before = A.flash_attention.launches
    split = A.flash_attention.split_v_launches
    out, cache = model.prefill(card_params, {k: v.to(cuda)
                                             for k, v in batch.items()}, 40)
    assert A.flash_attention.launches - before == _prefill_launches(cfg)
    # the SMOKE MLA's qk 24 and V 16 pad to (32, 32): no split instance
    assert A.flash_attention.split_v_launches == split
    assert _rel_t(out, ref) < MODEL_TOL
    tok = ref[:, -1].argmax(-1)
    for _ in range(4):
        ref, ref_cache = model.decode(cpu_params, ref_cache,
                                      {"tokens": tok[:, None]})
        out, cache = model.decode(card_params, cache,
                                  {"tokens": tok[:, None].to(cuda)})
        assert _rel_t(out, ref) < MODEL_TOL
        tok = ref[:, -1].argmax(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 17, 64, 1000])
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_attention_kernel_at_model_shapes_matches_its_plain_version(
        cuda, hkv, s, d):
    """The model's prefill attention at its shapes: bf16 activations, kv
    heads repeated to H = 4, cast to fp32, through the kernel against its
    plain version (2e-3); the model's function gives the kernel's output
    cast back to bf16, with one launch."""
    from repro_torch.models.attention import kernel_attention

    rng = np.random.default_rng(s * d + hkv)

    def act(heads):
        return torch.from_numpy(rng.standard_normal(
            (2, s, heads, d)).astype(np.float32)).to(cuda, torch.bfloat16)

    q, k, v = act(4), act(hkv), act(hkv)
    qh = q.transpose(1, 2).float().contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(4 // hkv, dim=1).float()
              .contiguous() for t in (k, v))
    got = A.flash_attention(qh, kh, vh)
    ref = A.flash_attention_plain(qh, kh, vh)
    assert _rel_t(got, ref) < 2e-3
    before = A.flash_attention.launches
    model_out = kernel_attention(q, k, v)
    assert A.flash_attention.launches == before + 1
    assert model_out.dtype == torch.bfloat16
    assert torch.equal(model_out, got.transpose(1, 2).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", [
    ((4, 32, 1024, 80), True),     # zamba2-2.7b's shared block
    ((4, 16, 4096, 64), False),    # seamless-m4t-large-v2's encoder
    ((4, 16, 64, 64), True),       # its decoder
], ids=["zamba2_shared", "seamless_encoder", "seamless_decoder"])
def test_attention_kernel_at_the_new_families_shapes(cuda, shape, causal):
    """The kernel against its plain version (2e-3) at the shapes the new
    families' prefills give it, bf16 activations cast to fp32; the model's
    function launches it once, causal or not."""
    from repro_torch.models.attention import kernel_attention

    b, h, s, d = shape
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(3))
    qh, kh, vh = (t.transpose(1, 2).float().contiguous() for t in (q, k, v))
    got = A.flash_attention(qh, kh, vh, causal=causal)
    ref = A.flash_attention_plain(qh, kh, vh, causal=causal)
    assert _rel_t(got, ref) < 2e-3
    other = A.flash_attention_plain(qh, kh, vh, causal=not causal)
    assert _rel_t(other, ref) > 1e-2
    before = A.flash_attention.launches
    model_out = kernel_attention(q, k, v, causal=causal)
    assert A.flash_attention.launches == before + 1
    assert torch.equal(model_out, got.transpose(1, 2).to(torch.bfloat16))


def _smoke_engine(cuda, arch="qwen2.5-3b", batch=2):
    from repro_torch.configs import SMOKES
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    model = build_model(SMOKES[arch].scaled(dtype="bfloat16"))
    return ServeEngine(model, batch_size=batch, max_seq=64,
                       generator=torch.Generator(cuda).manual_seed(0),
                       device=cuda)


def _serve_reqs(n=5, seed=0):
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, 500, size=int(
        rng.integers(3, 30))).astype(np.int32), max_new_tokens=6)
        for i in range(n)]


@pytest.mark.gpu
def test_the_engine_gives_the_same_tokens_twice(cuda):
    engine = _smoke_engine(cuda)
    a = engine.generate(_serve_reqs())
    b = engine.generate(_serve_reqs())
    assert a == b and all(len(v) == 6 for v in a.values())


@pytest.mark.gpu
def test_engine_backend_measure_synchronizes_before_it_reads_the_clock(
        cuda, monkeypatch):
    """CUDA is asynchronous: the wave's clock starts after the card's queue
    is drained and is read after it is drained again, under the card's
    timing lock."""
    import time as _time
    import types

    from repro_torch.core.evaluate import device_lock
    from repro_torch.serve import engine as E
    from repro_torch.serve.autotune import EngineBackend

    engine = _smoke_engine(cuda)
    backend = EngineBackend(engine.model, params=engine.params, device=cuda)
    cfg = {"BATCH": 2, "MAX_SEQ": 64}
    backend._engine(2, 64, n_requests=5)          # warm, untimed
    events = []
    sync = E.synchronize
    lock = device_lock(cuda)

    def logged_sync(dev):
        sync(dev)
        events.append(("sync", torch.cuda.current_stream(dev).query(),
                       lock.locked()))

    def clock():
        events.append(("clock",))
        return _time.perf_counter()

    monkeypatch.setattr(E, "synchronize", logged_sync)
    monkeypatch.setattr(E, "time", types.SimpleNamespace(perf_counter=clock))
    seconds = backend.measure(cfg, _serve_reqs())
    assert seconds > 0
    assert events == [("sync", True, True), ("clock",),
                      ("sync", True, True), ("clock",)]


@pytest.mark.gpu
def test_the_serve_cli_runs_on_the_card(cuda, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cuda", "--requests", "3", "--autotune",
         "--live-trials", "2", "--store", str(tmp_path / "store.json")],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "qwen2.5-smoke on cuda:0" in out.stdout
    assert "tuned live (trials=" in out.stdout


# --- training: KernelAttention, the kernel's guard, a step on the card --------
TRAIN_GRAD_TOL = 1e-4


def _kernel_and_plain_grads(shape, causal, device, seed=0):
    """Output and q/k/v gradients through KernelAttention (the kernel
    forward) and through autograd over the plain model attention, from the
    same fp32 leaves and output gradient."""
    from repro_torch.models import attention as MA

    gen = torch.Generator(device=device).manual_seed(seed)
    base = [torch.randn(shape, generator=gen, device=device) * 0.5
            for _ in range(4)]
    g = base[3]

    def leaves():
        return [t.clone().requires_grad_() for t in base[:3]]

    qk, kk, vk = leaves()
    out_k = MA.KernelAttention.apply(qk, kk, vk, causal, MA.KV_CHUNK)
    grads_k = torch.autograd.grad(out_k, (qk, kk, vk), g)
    qp, kp, vp = leaves()
    plain = MA.plain_causal_attention if causal else MA.chunked_attention
    out_p = plain(*(t.transpose(1, 2) for t in (qp, kp, vp))).transpose(1, 2)
    grads_p = torch.autograd.grad(out_p, (qp, kp, vp), g)
    return (out_k.detach(), *grads_k), (out_p.detach(), *grads_p)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
def test_kernel_attention_gradients_match_plain_autograd(cuda, d, causal):
    """Tolerance 1e-4 of the largest magnitude: the forward is the kernel
    (3xTF32, fp32-accurate) against the plain fp32 attention, and the
    gradients are the plain recompute's own."""
    before = A.flash_attention.launches
    got, want = _kernel_and_plain_grads((2, 3, 200, d), causal, cuda)
    assert A.flash_attention.launches == before + 1
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err < TRAIN_GRAD_TOL, (name, err)


@pytest.mark.gpu
def test_kernel_refuses_a_gradient_carrying_input_outside_the_function(cuda):
    q, k, v = _attention_args((1, 2, 128, 32), cuda)
    before = A.flash_attention.launches
    with pytest.raises(RuntimeError, match="KernelAttention"):
        A.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        A.flash_attention(q, k, v)
    assert A.flash_attention.launches == before + 1


@pytest.mark.gpu
def test_a_train_step_of_qwen_smoke_runs_on_the_card(cuda):
    """qwen1.5-smoke's loss and gradients on the card against the CPU from
    the same weights, within 1e-4 relative (each leaf by its L2 norm; fp32
    both, the kernel against its plain version, GEMMs in another order);
    then one step on the card: two kernel launches a layer (the forward
    and the remat recompute), every parameter moved."""
    from repro_torch.configs import SMOKES
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, constant_lr
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              loss_and_grads,
                                              make_train_step)

    cfg = SMOKES["qwen1.5-0.5b"]
    model = build_model(cfg)
    opt = AdamW(lr=constant_lr(1e-3))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=2), 0)
    cpu = init_train_state(model, opt, torch.Generator().manual_seed(0),
                           "cpu")
    card = init_train_state(model, opt, torch.Generator().manual_seed(0),
                            "cpu")
    card.params.to(cuda)
    card = card._replace(opt=opt.init(dict(card.params.named_parameters())),
                         step=card.step.to(cuda))
    l_cpu, g_cpu = loss_and_grads(model, cpu.params, to_device(batch, "cpu"),
                                  StepConfig())
    l_card, g_card = loss_and_grads(model, card.params,
                                    to_device(batch, cuda), StepConfig())
    assert abs(float(l_card) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
    for name, g in g_cpu.items():
        err = float((g_card[name].cpu() - g).norm() / g.norm())
        assert err < 1e-4, (name, err)
    start = {k: p.detach().clone() for k, p in card.params.named_parameters()}
    before = A.flash_attention.launches
    card, m = make_train_step(model, opt)(card, to_device(batch, cuda))
    assert A.flash_attention.launches - before == 2 * cfg.n_layers
    assert bool(torch.isfinite(m["loss"]))
    for k, p in card.params.named_parameters():
        assert not torch.equal(p.detach(), start[k]), k


# --- the sharded train step on a one-rank NCCL mesh ----------------------------
@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank (data, model) mesh over NCCL on the card, destroyed after
    the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, "cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def _smoke_states(cfg, opt, cuda):
    from repro_torch.models.registry import build_model
    from repro_torch.train.train_step import init_train_state

    model = build_model(cfg)
    return model, [init_train_state(
        model, opt, torch.Generator(device=cuda).manual_seed(0), cuda)
        for _ in range(2)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2.5-3b", "gemma-2b",
                                  "command-r-plus-104b",
                                  "llama4-scout-17b-a16e",
                                  "deepseek-v2-236b", "internvl2-76b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_the_one_rank_sharded_step_equals_the_plain_step(nccl_mesh, cuda,
                                                          arch):
    """A SMOKE arch's step through ``shard_train_state`` and
    ``make_train_step(mesh=...)`` on a one-rank NCCL mesh against the plain
    step from the same state on the same batch: loss and gradient norm
    within 1e-6 relative, every parameter within 1e-6 of its largest
    magnitude; the attention kernel launched as often by both (on rank 0's
    local heads: all of them) where the arch's attention takes it."""
    from repro_torch.configs import SMOKES
    from repro_torch.data.pipeline import (DataConfig, make_batch,
                                           shard_batch, to_device)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  default_rules)
    from repro_torch.optim.adamw import AdamW, constant_lr
    from repro_torch.train.train_step import (StepConfig, make_train_step,
                                              shard_train_state)

    cfg = SMOKES[arch]
    rules = default_rules(multi_pod=False)
    opt = AdamW(lr=constant_lr(1e-3))
    model, (plain, sharded) = _smoke_states(cfg, opt, cuda)
    sharded = shard_train_state(sharded, model, nccl_mesh, rules)
    host = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
        frontend_dim=cfg.frontend_dim), 0)
    runs = []
    for state, step, batch in (
            (plain, make_train_step(model, opt, StepConfig()),
             to_device(host, cuda)),
            (sharded, make_train_step(model, opt, StepConfig(),
                                      mesh=nccl_mesh, rules=rules),
             shard_batch(host, batch_shardings(nccl_mesh, rules, host)))):
        before = A.flash_attention.launches
        state, m = step(state, batch)
        torch.cuda.synchronize()
        runs.append((A.flash_attention.launches - before,
                     {k: float(v) for k, v in m.items()},
                     {k: getattr(p.detach(), "full_tensor", p.detach)()
                      for k, p in state.params.named_parameters()}))
    (n_want, want, want_params), (n_got, got, got_params) = runs
    # xLSTM takes no kernel; every other arch's GQA or MLA does
    assert n_got == n_want and (n_got > 0) == (not cfg.xlstm)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got, want)
    for k, p in want_params.items():
        err = float((got_params[k] - p).abs().max()
                    / p.abs().max().clamp_min(1e-30))
        assert err <= 1e-6, (k, err)


@pytest.mark.gpu
def test_the_kernel_runs_on_local_heads_under_activation_sharding(
        nccl_mesh, cuda):
    """Under ``activation_sharding`` the model's attention launches the
    kernel once a layer in the forward and once in each remat recompute,
    on the local tensors (never the plain version), and a recompute in the
    backward pass on the autograd engine's thread runs under the forward's
    resolver."""
    from repro_torch.configs import SMOKES
    from repro_torch.data.pipeline import (DataConfig, make_batch,
                                           shard_batch)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  default_rules)
    from repro_torch.optim.adamw import AdamW, constant_lr
    from repro_torch.train.train_step import (StepConfig, loss_and_grads,
                                              on_mesh, shard_train_state)

    cfg = SMOKES["qwen2.5-3b"]
    rules = default_rules(multi_pod=False)
    opt = AdamW(lr=constant_lr(1e-3))
    model, (state, _) = _smoke_states(cfg, opt, cuda)
    state = shard_train_state(state, model, nccl_mesh, rules)
    host = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=2), 0)
    batch = shard_batch(host, batch_shardings(nccl_mesh, rules, host))
    plain = A.flash_attention_plain
    calls = []
    A.flash_attention_plain = lambda *a, **kw: calls.append(1) or plain(
        *a, **kw)
    try:
        for remat, per_layer in (("none", 1), ("nothing_saveable", 2)):
            before = A.flash_attention.launches
            with on_mesh(nccl_mesh, rules):
                loss, grads = loss_and_grads(model, state.params, batch,
                                             StepConfig(remat=remat))
            torch.cuda.synchronize()
            assert A.flash_attention.launches - before == \
                per_layer * cfg.n_layers, remat
            assert bool(torch.isfinite(loss.full_tensor()))
            assert len(grads) == sum(1 for _ in state.params.parameters())
    finally:
        A.flash_attention_plain = plain
    assert not calls


@pytest.mark.gpu
def test_the_fleet_tunes_a_whole_system_on_the_card(cuda, tmp_path):
    """``python -m repro_torch.launch.fleet --system`` on a lane on cuda:0
    with a budget of 2: every kernel job measured there (the lane launched
    each kernel), the sharding and serve jobs priced, one store."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.core import hwspec
    from repro_torch.tuning.problem import system_problems

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out = tmp_path / "system.json"
    hw = hwspec.hardware_key(hwspec.detect())
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--system",
         "qwen2.5-3b", "--hw", hw, "--budget", "2", "--devices", "cuda:0",
         "--store", str(tmp_path / "store.json"), "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert res.returncode == 0, res.stderr[-3000:]
    rep = json.loads(out.read_text())
    assert sorted(j["job"] for j in rep["jobs"]) == sorted(
        f"{p.spec}@{hw}" for p in system_problems("qwen2.5-3b"))
    assert all(j["trials"] == 2 and j["best_runtime_s"] < float("inf")
               for j in rep["jobs"])
    (lane,) = rep["lanes"]
    assert lane["device"] == "cuda:0"
    assert all(lane["launches"].get(k, 0) > 0 for k in BENCHMARKS), lane


# --- the dry run and step tuning on the card ------------------------------------
# measured / predicted peak of a qwen1.5-smoke step (8 x 128), read as
# the step tuner reads it
DRY_PEAK_TOL = 0.06
@pytest.fixture
def smoke_qwen(monkeypatch):
    """qwen1.5-0.5b's SMOKE config under its name, for the step tuner and
    the dry run."""
    import repro_torch.configs as cfgs
    import repro_torch.launch.dryrun as dryrun
    from repro_torch.configs import SMOKES

    archs = dict(cfgs.ARCHS, **{"qwen1.5-0.5b": SMOKES["qwen1.5-0.5b"]})
    monkeypatch.setattr(cfgs, "ARCHS", archs)
    monkeypatch.setattr(dryrun, "ARCHS", archs)
    return SMOKES["qwen1.5-0.5b"]


@pytest.mark.gpu
def test_the_dry_runs_launches_are_the_cards(cuda, smoke_qwen):
    """The dry run's count of a qwen1.5-smoke step launches the kernel as
    often as the same step on the card does (twice a layer under
    nothing_saveable), and predicts the step's own peak memory (as
    ``MeasuredStepEvaluator`` reads it) within DRY_PEAK_TOL; every timed
    loss is finite."""
    from repro_torch.core.step_tuner import STEPS_TIMED, MeasuredStepEvaluator
    from repro_torch.launch import dryrun
    from repro_torch.train.train_step import StepConfig

    scfg = StepConfig(loss_chunks=1)
    count = dryrun.count_train_step("qwen1.5-0.5b", scfg, 8, 128)
    ev = MeasuredStepEvaluator("qwen1.5-0.5b", 8, 128, cuda, verbose=False)
    cfg = {"MICROBATCHES": 1, "REMAT": scfg.remat, "LOSS_CHUNKS": 1,
           "KV_CHUNK": scfg.kv_chunk, "FSDP": 0}
    before = A.flash_attention.launches
    ev._evaluate(ev.space.index_of(cfg), False)
    launches = (A.flash_attention.launches - before) / (STEPS_TIMED + 1)
    assert launches == count.launches["attention"] == 2 * smoke_qwen.n_layers
    test = ev.tests[-1]
    ratio = test["peak_bytes"] / count.peak_bytes
    print(f"measured / predicted peak {ratio:.4f}")
    assert abs(ratio - 1.0) < DRY_PEAK_TOL, (test, count.peak_bytes, ratio)
    assert all(math.isfinite(x) for x in test["losses"])


@pytest.mark.gpu
def test_the_measured_step_tune_runs_on_the_card(cuda, smoke_qwen, tmp_path,
                                                 monkeypatch):
    """``launch.tune --backend measured`` on qwen1.5-smoke with a budget
    of 2: each test a timed step on the card (the kernel launched, its
    plain version never called), the best a measured one."""
    import json

    import repro_torch.kernels.attention.kernel as K
    from repro_torch.launch import tune

    plain = []
    monkeypatch.setattr(K, "flash_attention_plain",
                        lambda *a, **kw: plain.append(1))
    out = tmp_path / "t.json"
    before = A.flash_attention.launches
    assert tune.main(["--arch", "qwen1.5-0.5b", "--backend", "measured",
                      "--batch", "8", "--seq", "128", "--searcher",
                      "random", "--budget", "2", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["steps"] == 2 and len(rec["tests"]) == 2
    assert all(t["seconds"] > 0 and t["peak_bytes"] > 0
               for t in rec["tests"])
    assert all(len(t["losses"]) == 3 and all(x == x and abs(x) < 1e30
                                             for x in t["losses"])
               for t in rec["tests"])
    assert rec["best_ms"] == pytest.approx(
        1e3 * min(t["seconds"] for t in rec["tests"]))
    assert A.flash_attention.launches > before and not plain


# --- the dry run's cells that torch 2.11's DTensor refused ------------------
# each (SMOKE arch, cell) on a 2x2 fake mesh, at the sizes of
# tests/test_torch_dryrun.py; this file runs under the card machine's torch
DRY_211_CELLS = [(arch, cell) for arch in ("deepseek-v2-236b",
                                           "llama4-scout-17b-a16e")
                 for cell in ("train_4k", "prefill_32k", "decode_32k")] \
    + [("xlstm-125m", "decode_32k")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cell", DRY_211_CELLS,
                         ids=[f"{a}-{c}" for a, c in DRY_211_CELLS])
def test_the_dry_run_counts_the_moe_and_xlstm_decode_cells(cuda, monkeypatch,
                                                           arch, cell):
    """The MoE archs' cells and xlstm-125m's decode count on a 2x2 fake
    mesh under this machine's torch: the MoE's capacity combine as one
    batched product over expert-major pairs, the dropless MoE's
    ``index_add_`` and the mLSTM decode's read-out on local shards
    (``distributed.api``).  Nothing of the card is used: the test is
    marked so that it runs where the card's torch is."""
    import warnings

    from repro_torch.configs import SMOKES
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshes
    from repro_torch.models.config import ShapeConfig

    shapes = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
              "prefill_32k": ShapeConfig("prefill_32k", 128, 4, "prefill"),
              "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode")}
    monkeypatch.setattr(dryrun, "ARCHS", dict(SMOKES))
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    monkeypatch.setattr(meshes, "production_shape",
                        lambda multi_pod=False: ((2, 2), ("data", "model")))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec, count = dryrun.count_cell(arch, cell, False)
    print(f"torch {torch.__version__}: {arch} {cell} products "
          f"{count.product_flops:.6g}, collective bytes "
          f"{sum(count.collective_bytes.values()):.6g}, peak "
          f"{count.peak_bytes:.6g}")
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert count.product_flops > 0 and sum(count.collective_bytes.values()) > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
