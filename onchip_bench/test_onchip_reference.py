"""The plain references against NumPy at tiny sizes, TF32 rounding, and the
control at a size a test run holds: the reference in TF32 put in the
program's place fails the configuration's limit on the kernel's error,
where the port's kernel (its plain version on the CPU) meets it."""
import math

import numpy as np
import pytest
import torch

import harness
from tf32 import to_tf32

REF = harness.BENCH_DIR / "reference"


def limit(config: str) -> float:
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{config}.json"
                             )["check"]["kernel_rel_err"]


def test_matmul_reference_is_numpys_product():
    ref = harness.load_file(REF / "matmul.py")
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((17, 23)), rng.standard_normal((23, 11))
    out = ref.reference(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float())
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), a.astype(np.float32).astype(
        np.float64) @ b.astype(np.float32).astype(np.float64), rtol=1e-12)


def numpy_attention(q, k, v):
    b, h, s, d = q.shape
    out = np.zeros_like(q)
    for i in range(b):
        for j in range(h):
            for t in range(s):
                w = np.array([q[i, j, t] @ k[i, j, u] / math.sqrt(d)
                              for u in range(t + 1)])
                w = np.exp(w - w.max())
                out[i, j, t] = (w / w.sum()) @ v[i, j, :t + 1]
    return out


def test_attention_reference_is_causal_softmax_attention():
    ref = harness.load_file(REF / "attention.py")
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, 9, 8)).astype(np.float32)
               for _ in range(3))
    out = ref.reference(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), numpy_attention(
        *(t.astype(np.float64) for t in (q, k, v))), rtol=1e-10, atol=1e-12)


def test_tf32_rounds_to_nearest_ten_bit_mantissa():
    x = torch.tensor([1 + 2**-12, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11),
                      3.0], dtype=torch.float32)
    assert to_tf32(x).tolist() == [1.0, 1 + 2**-10, 1 + 2**-10,
                                   -(1 + 2**-10), 3.0]
    y = to_tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert not (y.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("config", ["gemm-2048", "attention-qwen1.5-0.5b"])
def test_the_control_fails_where_the_kernel_passes(config):
    cell = next(w["name"] for w in harness.with_withheld(harness.load_json(
        harness.CHECKOUT / "BENCHMARK.json"))["workloads"]
        if w["config"] == config)
    c = harness.resolve(cell, withheld=True)
    from repro_torch.kernels.registry import BENCHMARKS

    bench = BENCHMARKS[c.kernel.KERNEL]
    sizes = ({"m": 256, "n": 256, "k": 256} if c.kernel.KERNEL == "matmul"
             else {"batch": 1, "heads": 4, "seq": 256, "head_dim": 64,
                   "causal": True})
    inp = c.kernel.make_input(sizes)
    args = c.kernel.make_args(inp, torch.Generator().manual_seed(3), "cpu")
    ref = c.reference.reference(*args)
    space = c.kernel.make_space(bench, inp)
    kernel = max(harness.rel_err(bench.run(space[i], *args), ref)
                 for i in range(0, len(space), max(1, len(space) // 4)))
    control = harness.rel_err(c.reference.control(*args), ref)
    assert kernel < limit(config) < control
