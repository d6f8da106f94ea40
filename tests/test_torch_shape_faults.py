"""Inputs the JAX package computes and the port once refused: attention at
any head dim from 1 to 256, and conv2d with UNROLL_TAPS = 1 at any odd F up
to ``MAX_F``.

On the CPU the wrappers take their plain versions, so these tests hold
those against the JAX package (the Pallas attention kernel in interpret
mode, conv2d's ``lax.conv_general_dilated`` oracle: the Pallas conv2d's
looped path does not run under this jax), and hold the rules the card
follows: which head dims and filter sizes are compiled (against the C
sources' switches), how a head dim is padded, which kernel an F runs, and
that a tune refuses an F above ``MAX_F`` before its first test.  The CUDA
kernels at every compiled D and each odd F are tested on the card in
``test_torch_gpu.py``.

Tolerances, relative to max |reference|: attention 2e-3, conv2d 1e-3, those
of the JAX package's kernel tests."""
import re

import jax  # noqa: F401  (both frameworks load in every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.kernel import flash_attention_single_head
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.core import hwspec as phw
from repro_torch.core.evaluate import DeviceKernelEvaluator
from repro_torch.core.searcher import make_searcher, run_search
from repro_torch.kernels import common
from repro_torch.kernels.attention import kernel as A
from repro_torch.kernels.conv2d import kernel as CV
from repro_torch.kernels.conv2d.space import ConvInput
from repro_torch.kernels.registry import BENCHMARKS


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _switch(source, macro):
    text = (common.CSRC_DIR / source).read_text()
    return tuple(int(v) for v in re.findall(rf"^\s*{macro}\((\d+)\)", text,
                                            re.M))


# --- attention: head dims -----------------------------------------------------

def test_compiled_head_dims_are_the_c_entrys():
    assert A.HEAD_DIMS == _switch("attention.cu", "REPRO_ATTENTION_D")
    assert all(d % 8 == 0 for d in A.HEAD_DIMS)    # mma.sync m16n8k8
    assert A.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("d,padded", [(1, 16), (16, 16), (17, 32), (48, 64),
                                      (64, 64), (65, 80), (80, 80), (96, 128),
                                      (129, 192), (200, 256), (256, 256)])
def test_a_head_dim_pads_to_the_next_compiled_one(d, padded):
    assert A.padded_head_dim(d) == padded


@pytest.mark.parametrize("d", [0, 257, 320])
def test_head_dims_outside_1_to_256_are_refused(d):
    x = torch.zeros((1, 1, 8, d))
    with pytest.raises(ValueError, match="256"):
        A.flash_attention(x, x, x)


def _heads(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) * 0.3
            for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 1, 128, 16), (1, 2, 128, 32),
                                   (1, 1, 96, 48), (1, 1, 64, 80)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cpu_attention_matches_pallas_at_small_head_dims(shape):
    """The JAX package's single-head kernel takes any D; the port's CPU path
    matches it, head by head, in interpret mode."""
    q, k, v = _heads(shape)
    out = A.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.shape == shape
    for b in range(shape[0]):
        for h in range(shape[1]):
            ref = flash_attention_single_head(
                jnp.asarray(q[b, h]), jnp.asarray(k[b, h]),
                jnp.asarray(v[b, h]), block_q=64, block_k=64, causal=True,
                sm_scale=1.0 / shape[3] ** 0.5, interpret=True)
            assert _rel(out[b, h].numpy(), ref) < 2e-3


@pytest.mark.parametrize("d", [1, 8, 24, 48, 80, 100, 200])
def test_zero_padding_a_head_changes_nothing(d):
    """What the card runs at a padded D: the heads zero-padded to
    ``padded_head_dim(d)``, the scale 1/sqrt(d), the padding sliced off.
    The plain version of that equals the plain version at d."""
    q, k, v = (torch.from_numpy(t) for t in _heads((1, 2, 80, d), seed=d))
    pad = A.padded_head_dim(d) - d
    padded = [torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)]
    out = A.flash_attention_plain(*padded, sm_scale=1.0 / d ** 0.5)
    assert bool((out[..., d:] == 0).all())
    ref = A.flash_attention_plain(q, k, v)
    assert _rel(out[..., :d].numpy(), ref.numpy()) < 1e-6


# --- conv2d: unrolled filter sizes --------------------------------------------

def test_unrolled_filter_sizes_are_the_c_entrys():
    assert CV.UNROLLED_F == _switch("conv2d.cu", "REPRO_CONV2D_F")
    assert CV.MAX_F == 31


@pytest.mark.parametrize("f", range(1, CV.MAX_F + 1, 2))
def test_unrolled_taps_lower_to_the_looped_kernel_above_the_compiled_f(f):
    """UNROLL_TAPS = 1 runs the kernel compiled for F where there is one,
    else the looped kernel: then the two values of UNROLL_TAPS are one code
    path under two configurations."""
    assert CV.taps_kernel(f, 0) == 0
    assert CV.taps_kernel(f, 1) == (f if f in CV.UNROLLED_F else 0)


@pytest.mark.parametrize("h,w,f", [(40, 61, 9), (33, 70, 11), (20, 45, 15),
                                   (50, 40, 31)])
@pytest.mark.parametrize("unroll", [1, 0])
def test_cpu_conv2d_unrolled_at_large_f_matches_the_jax_oracle(h, w, f,
                                                               unroll):
    rng = np.random.default_rng(f)
    img = rng.standard_normal((h, w), dtype=np.float32)
    flt = rng.standard_normal((f, f), dtype=np.float32)
    oracle = jax_conv2d_ref(jnp.asarray(img), jnp.asarray(flt))
    out = CV.conv2d(torch.from_numpy(img), torch.from_numpy(flt),
                    unroll_taps=unroll)
    assert out.shape == (h, w)
    assert _rel(out.numpy(), oracle) < 1e-3


@pytest.mark.parametrize("f", [9, CV.MAX_F])
def test_a_whole_space_tune_at_a_large_f_runs_to_its_end(f):
    """Every configuration of the conv2d space, UNROLL_TAPS = 1 included,
    runs at F = 9 and F = MAX_F: a tune over the whole space ends with
    every configuration measured."""
    bench = BENCHMARKS["conv2d"]
    space = bench.make_space()
    ev = DeviceKernelEvaluator(space, bench, ConvInput(24, 40, f),
                               hw=phw.H100_SXM, device="cpu", reps=1,
                               warmup=0)
    run_search(make_searcher("random", space, seed=0), ev, len(space))
    assert ev.steps == len(space) and len(ev.measured) == len(space)
    assert np.isfinite(ev.recorded().runtimes).all()


@pytest.mark.parametrize("f", [33, 4, 0])
def test_a_tune_refuses_an_f_the_kernel_never_takes_before_its_first_test(f):
    bench = BENCHMARKS["conv2d"]
    with pytest.raises(ValueError, match="odd F x F filter"):
        DeviceKernelEvaluator(bench.make_space(), bench, ConvInput(24, 40, f),
                              hw=phw.H100_SXM, device="cpu")
