"""The MLA cell's files on the CPU: its plain reference against an
independent float64 softmax·V with V narrower than q and k, its work
reducing to the attention cells' at Dv = Dqk, and its control: the
reference in TF32 put in the program's place fails the configuration's
limit on the kernel's error, where the port's kernel (its plain version on
the CPU) meets it."""
import math

import numpy as np
import torch

import harness

CELL = "mla-deepseek-v2.profile"


def numpy_attention(q, k, v):
    b, h, s, _ = q.shape
    out = np.zeros(v.shape)
    for i in range(b):
        for j in range(h):
            for t in range(s):
                w = np.array([q[i, j, t] @ k[i, j, u] / math.sqrt(q.shape[-1])
                              for u in range(t + 1)])
                w = np.exp(w - w.max())
                out[i, j, t] = (w / w.sum()) @ v[i, j, :t + 1]
    return out


def test_reference_is_causal_softmax_attention_with_its_own_v_dim():
    ref = harness.load_file(harness.BENCH_DIR / "reference" /
                            "mla_attention.py")
    rng = np.random.default_rng(2)
    q, k = (rng.standard_normal((2, 3, 9, 12)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 3, 9, 8)).astype(np.float32)
    out = ref.reference(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.dtype == torch.float64 and out.shape == (2, 3, 9, 8)
    np.testing.assert_allclose(out.numpy(), numpy_attention(
        *(t.astype(np.float64) for t in (q, k, v))), rtol=1e-10, atol=1e-12)
    control = ref.control(*(torch.from_numpy(t) for t in (q, k, v)))
    assert control.dtype == torch.float32 and control.shape == out.shape


def test_work_reduces_to_the_attention_cells_at_equal_head_dims():
    mla = harness.load_file(harness.BENCH_DIR / "kernels" /
                            "mla_attention.py")
    gqa = harness.load_file(harness.BENCH_DIR / "kernels" / "attention.py")
    for b, h, s, d in ((8, 16, 1024, 64), (1, 16, 2048, 192), (2, 3, 7, 80)):
        sizes = {"batch": b, "heads": h, "seq": s, "head_dim": d,
                 "causal": True}
        assert mla.work(mla.make_input(dict(sizes, v_head_dim=d))) == \
            gqa.work(gqa.make_input(sizes))
    cell = harness.resolve(CELL)
    inp = cell.kernel.make_input(cell.config["input"])
    nbytes, fp32, sfu, tensor = cell.kernel.work(inp)
    pairs = 16 * 2048 * 2049 / 2
    assert nbytes == 4 * 16 * 2048 * (2 * 192 + 2 * 128)
    assert fp32 == tensor == 2 * (192 + 128) * pairs and sfu == pairs


def test_the_control_fails_where_the_kernel_passes():
    cell = harness.resolve(CELL)
    from repro_torch.kernels.registry import BENCHMARKS

    bench = BENCHMARKS[cell.kernel.KERNEL]
    inp = cell.kernel.make_input({"batch": 1, "heads": 4, "seq": 256,
                                  "head_dim": 192, "v_head_dim": 128,
                                  "causal": True})
    args = cell.kernel.make_args(inp, torch.Generator().manual_seed(3),
                                 "cpu")
    assert args[2].shape == (1, 4, 256, 128)
    ref = cell.reference.reference(*args)
    space = cell.kernel.make_space(bench, inp)
    kernel = max(harness.rel_err(bench.run(space[i], *args), ref)
                 for i in range(0, len(space), max(1, len(space) // 4)))
    control = harness.rel_err(cell.reference.control(*args), ref)
    limit = cell.config["check"]["kernel_rel_err"]
    assert kernel < limit < control
