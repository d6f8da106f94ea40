"""The port's GEMM: the wrapper's CPU path (the kernel's plain version)
against the Pallas kernel in interpret mode and the JAX oracle, and the
card evaluator on the CPU.  The CUDA kernel's own tests are in
``test_torch_gpu.py``.

Tolerance: relative 2e-4 of max |reference|, the matmul tolerance of the
JAX package's kernel tests; the sums run in another order."""
import jax  # noqa: F401  (both frameworks load in every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.kernel import matmul as jax_matmul
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.core import counters as PC
from repro_torch.core import hwspec
from repro_torch.core.evaluate import DeviceKernelEvaluator
from repro_torch.kernels import common
from repro_torch.kernels.matmul import kernel as K
from repro_torch.kernels.matmul import space as S
from repro_torch.kernels.registry import BENCHMARKS
from repro_torch.tuning import TuningSession

TOL = 2e-4
SHAPES = [(128, 128, 128), (192, 256, 128), (256, 192, 320), (64, 512, 96),
          (100, 200, 300)]
CONFIGS = [(64, 128, 128, "mnk"), (128, 128, 256, "nmk"),
           (64, 128, 128, "nmk"), (128, 128, 256, "mnk")]


def _inputs(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _kw(cfg):
    bm, bn, bk, order = cfg
    return dict(block_m=bm, block_n=bn, block_k=bk, loop_order=order)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cpu_matmul_matches_pallas_interpret_and_oracle(shape, cfg):
    a, b = _inputs(*shape)
    before = K.matmul.launches
    ours = K.matmul(torch.from_numpy(a), torch.from_numpy(b), **_kw(cfg))
    assert K.matmul.launches == before      # the CPU path launches nothing
    assert ours.shape == (shape[0], shape[1]) and ours.dtype == torch.float32
    pallas = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True,
                        **_kw(cfg))
    oracle = jax_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    assert _rel(ours.numpy(), pallas) < TOL
    assert _rel(ours.numpy(), oracle) < TOL


def test_make_args_draws_the_jax_packages_arrays():
    from repro.kernels.registry import BENCHMARKS as JB

    inp = S.GemmInput(32, 48, 40)
    ours = BENCHMARKS["matmul"].make_args(inp, np.random.default_rng(5), "cpu")
    theirs = JB["matmul"].make_args(inp, np.random.default_rng(5))
    for o, t in zip(ours, theirs):
        assert np.array_equal(o.numpy(), np.asarray(t))


@pytest.mark.parametrize("bad,err", [
    (lambda a, b: (a.double(), b.double()), TypeError),
    (lambda a, b: (a, b[:-1]), ValueError),
    (lambda a, b: (a.t(), b), ValueError),
    (lambda a, b: (a[:, ::2], b[::2]), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    a, b = (torch.from_numpy(x) for x in _inputs(16, 16, 16))
    with pytest.raises(err):
        K.matmul(*bad(a, b))


@pytest.mark.parametrize("kw", [dict(loop_order="kmn"), dict(block_m=0)])
def test_wrapper_rejects_bad_parameters(kw):
    a, b = (torch.from_numpy(x) for x in _inputs(16, 16, 16))
    with pytest.raises(ValueError):
        K.matmul(a, b, **kw)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build(K.SOURCE)


def test_library_name_follows_the_source():
    path = common.library_path(K.SOURCE)
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("matmul-") and path.suffix == ".so"
    assert path == common.library_path(K.SOURCE)


def test_cpu_evaluator_reports_hopper_counters():
    bench = BENCHMARKS["matmul"]
    inp = bench.inputs["128"]
    space = S.make_space(inp)
    with pytest.raises(ValueError, match="hw="):
        DeviceKernelEvaluator(space, bench, inp, device="cpu")
    ev = DeviceKernelEvaluator(space, bench, inp, hw=hwspec.H100_SXM,
                               device="cpu", reps=2, warmup=1)
    assert ev.device_name == "cpu"
    cs = ev.profile(0)
    assert cs.runtime > 0 and ev.steps == 1 and ev.elapsed > 0
    assert set(cs.ops) <= set(PC.PC_OPS) and PC.DRAM_RD in cs.ops
    assert PC.WARP_E_HINT not in cs.ops
    assert set(cs.stress) == set(PC.PC_STRESS)
    assert all(0.0 <= v <= 1.0 for v in cs.stress.values())
    assert ev.measure(1) > 0
    with pytest.raises(ValueError, match="measured"):
        ev.recorded()


def test_cpu_evaluator_records_a_whole_space():
    bench = BENCHMARKS["matmul"]
    inp = S.GemmInput(16, 64, 64)
    space = S.make_space(inp)
    ev = DeviceKernelEvaluator(space, bench, inp, hw=hwspec.H100_SXM,
                               device="cpu", reps=1, warmup=0)
    for i in range(len(space)):
        ev.measure(i)
    rec = ev.recorded()
    assert rec.input_tag == "16x64x64@cpu"
    assert rec.runtimes.shape == (len(space),) and rec.best_runtime > 0


def test_train_on_evaluator_then_tune_on_the_cpu(tmp_path):
    bench = BENCHMARKS["matmul"]
    hw = hwspec.H100_SXM

    def session(inp):
        return TuningSession(
            S.make_space(inp), lambda c: bench.workload_fn(c, inp), hw=hw,
            evaluator_factory=lambda sp: DeviceKernelEvaluator(
                sp, bench, inp, hw=hw, device="cpu", reps=1, warmup=0))

    trainer = session(S.GemmInput(16, 128, 128))
    trainer.train_on_evaluator(trainer.make_evaluator())
    path = trainer.save_model(str(tmp_path / "m.json"))
    tuner = session(S.GemmInput(128, 128, 128))
    tuner.load_model(path)
    result = tuner.tune(budget=5, searcher="profile")
    assert result.steps == 5
    assert result.best_config in tuner.space.configs
