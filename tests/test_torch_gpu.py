"""Tests that need a CUDA card: the port's kernels against their plain
PyTorch versions on the card, and the card evaluator.

This file imports no JAX, so that it runs where the card is and JAX is not:
``python -m pytest -m gpu tests/test_torch_gpu.py``.  Without a card every
test skips, decided at run time by the ``cuda`` fixture.

Tolerance: relative 2e-4 of max |plain|, the matmul tolerance of the JAX
package's kernel tests; the sums run in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.evaluate import DeviceKernelEvaluator
from repro_torch.kernels.matmul import kernel as K
from repro_torch.kernels.matmul import space as S
from repro_torch.kernels.registry import BENCHMARKS

TOL = 2e-4


@pytest.fixture
def cuda():
    """The card; skips (at run time, never at import) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    assert entry(None, None, None, 0, 1, 1, 64, 64, 64, 0, None) != 0
    monkeypatch.setattr(K, "_entry", lambda: (lambda *args: 1))
    a, b = _inputs(64, 64, 64, cuda)
    before = K.matmul.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K.matmul(a, b)
    assert K.matmul.launches == before
