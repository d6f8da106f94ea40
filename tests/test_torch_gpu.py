"""Tests that need a CUDA card: the port's kernels against their plain
PyTorch versions on the card, and the card evaluator.

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
import importlib

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
    assert entry(None, None, None, None, 1, 64, 64, 96, 64, 1, 1, 1, 1.0,
                 None) != 0
    assert entry(None, None, None, None, 1, 64, 32, 64, 64, 1, 1, 1, 1.0,
                 None) != 0
    monkeypatch.setattr(A, "_entry", lambda: (lambda *args: 1))
    before = A.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        A.flash_attention(*_attention_args((1, 1, 64, 64), cuda))
    assert A.flash_attention.launches == before


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
# rows whose W % 4 != 0 (4-byte copies), F = 1 and 7 unrolled, F = 9 looped,
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
