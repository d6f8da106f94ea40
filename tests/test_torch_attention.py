"""The port's flash attention against the JAX package: the space and the
workload model number for number under ``counters.TPU_NAMES``, the inputs
drawn bit for bit, the wrapper's CPU path (the kernel's plain version)
against the Pallas kernel in interpret mode and the JAX oracle, and the
searchers and the session on the attention space.  The CUDA kernel's own
tests are in ``test_torch_gpu.py``.

Tolerance, relative to max |reference|: 2e-3, that of the JAX package's
kernel tests (``tests/test_kernels.py``)."""
import dataclasses
import json

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch

from repro.core import evaluate as jev
from repro.core import hwspec as jhw
from repro.core import searcher as jse
from repro.core import tuner as jtu
from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention import space as jspace
from repro.kernels.registry import BENCHMARKS as JB
from repro.tuning import TuningSession as JSession
from repro_torch.core import evaluate as pev
from repro_torch.core import hwspec as phw
from repro_torch.core import searcher as pse
from repro_torch.core import tuner as ptu
from repro_torch.kernels import common
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention import space as pspace
from repro_torch.kernels.registry import BENCHMARKS as PB
from repro_torch.tuning import TuningSession as PSession
from repro_torch.tuning import from_jax_artifact
from test_torch_space_costmodel import port_spec, to_tpu

TOL = 2e-3
# (B, H, S, D): the registry input and the inputs the tests run
SHAPES = [(4, 16, 4096, 128), (1, 2, 256, 64), (1, 2, 384, 128),
          (1, 2, 200, 64), (2, 3, 1000, 64)]


def _inputs(shape, causal=True):
    return (jspace.AttentionInput(*shape, causal=causal),
            pspace.AttentionInput(*shape, causal=causal))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


# --- (a) space and workload model ---------------------------------------------

def test_space_is_identical():
    j, p = JB["attention"].make_space(), PB["attention"].make_space()
    assert len(p) == 64 and p.name == j.name == "attention"
    assert p.configs == j.configs
    assert np.array_equal(p.feature_matrix, j.feature_matrix)
    assert np.array_equal(p.subspace_key_matrix, j.subspace_key_matrix)


def test_registry_entry_is_identical():
    j, p = JB["attention"], PB["attention"]
    assert list(p.inputs) == list(j.inputs) == ["default"]
    assert dataclasses.astuple(p.default_input) == \
        dataclasses.astuple(j.default_input) == (4, 16, 4096, 128, True, 2)
    assert p.default_input.tag == j.default_input.tag == "b4h16s4096d128"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_workload_fn_equals_jax_under_the_name_map(shape, causal):
    jinp, pinp = _inputs(shape, causal)
    for cfg in JB["attention"].make_space():
        ours = to_tpu(pspace.workload_fn(cfg, pinp))
        theirs = jspace.workload_fn(cfg, jinp)
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12,
                                       atol=0, err_msg=f"{cfg} {k}")


def test_workload_model_prices_two_byte_elements_as_the_jax_one_does():
    """The registry runs fp32, the model prices 2-byte elements: a fault of
    the reference (ROADMAP queue 3) that the port carries as it is."""
    assert pspace.DEFAULT_INPUT.dtype_bytes == jspace.DEFAULT_INPUT.dtype_bytes \
        == 2
    cfg = PB["attention"].make_space()[0]
    s, d, heads = 4096, 128, 64
    assert pspace.workload_fn(cfg)["DRAM_WR"] == heads * s * d * 2


# --- (b) inputs ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 40, 64), (2, 1, 33, 128)])
def test_make_args_draws_the_jax_packages_arrays(shape):
    jinp, pinp = _inputs(shape)
    ours = PB["attention"].make_args(pinp, np.random.default_rng(5), "cpu")
    theirs = JB["attention"].make_args(jinp, np.random.default_rng(5))
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        assert o.device.type == "cpu" and o.dtype == torch.float32
        assert o.shape == shape
        assert np.array_equal(o.numpy(), np.asarray(t))


# --- (c) the wrapper's CPU path against the Pallas kernel and the oracle ------

def _args(shape, seed=0):
    jinp, pinp = _inputs(shape)
    ours = PB["attention"].make_args(pinp, np.random.default_rng(seed), "cpu")
    theirs = JB["attention"].make_args(jinp, np.random.default_rng(seed))
    return ours, theirs


CPU_CASES = [((1, 2, 256, 64), (128, 128)), ((1, 2, 256, 64), (128, 256)),
             ((1, 2, 384, 128), (128, 128)), ((1, 2, 384, 128), (128, 256)),
             ((1, 2, 200, 64), (128, 128))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,blocks", CPU_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{b[0]}-{b[1]}"
                              for s, b in CPU_CASES])
def test_cpu_path_matches_pallas_and_oracle(shape, blocks, causal):
    ours, theirs = _args(shape)
    bq, bk = blocks
    pallas = jax_flash_attention(*theirs, block_q=bq, block_k=bk,
                                 causal=causal, interpret=True)
    oracle = JB["attention"].ref(*theirs, causal=causal)
    before = K.flash_attention.launches
    for keep_p in (0, 1):
        for prefetch in (1, 2):
            out = K.flash_attention(*ours, block_q=bq, block_k=bk,
                                    keep_p=keep_p, q_prefetch=prefetch,
                                    causal=causal)
            assert out.shape == shape and bool(out.isfinite().all())
            assert _rel(out.numpy(), pallas) < TOL
            assert _rel(out.numpy(), oracle) < TOL
    assert K.flash_attention.launches == before   # the CPU launches nothing
    assert _rel(PB["attention"].ref(*ours, causal=causal).numpy(),
                oracle) < TOL


def test_registry_run_takes_every_configuration_on_the_cpu():
    ours, theirs = _args((1, 1, 130, 64))
    oracle = JB["attention"].ref(*theirs)
    for cfg in PB["attention"].make_space():
        out = PB["attention"].run(cfg, *ours)
        assert _rel(out.numpy(), oracle) < TOL


def test_plain_version_chunks_over_heads(monkeypatch):
    ours, theirs = _args((2, 3, 100, 64))
    whole = K.flash_attention_plain(*ours)
    monkeypatch.setattr(K, "SCORES_PER_CHUNK", 2 * 100 * 100)   # 3 chunks
    chunked = K.flash_attention_plain(*ours)
    assert _rel(chunked.numpy(), whole.numpy()) < 1e-6
    assert _rel(chunked.numpy(), JB["attention"].ref(*theirs)) < TOL


def test_plain_version_takes_the_scale():
    ours, theirs = _args((1, 2, 64, 64))
    out = K.flash_attention_plain(*ours, sm_scale=0.5)
    ref = jax_flash_attention(*theirs, block_q=128, block_k=128,
                              sm_scale=0.5, interpret=True)
    assert _rel(out.numpy(), ref) < TOL


# --- wrapper and build guards -------------------------------------------------

def _bad_calls():
    x = torch.zeros((1, 2, 64, 64))
    return [
        ("f64", lambda: K.flash_attention(x.double(), x.double(),
                                          x.double())),
        ("head-dim-32", lambda: K.flash_attention(x[..., :32].contiguous(),
                                                  x[..., :32].contiguous(),
                                                  x[..., :32].contiguous())),
        ("3d", lambda: K.flash_attention(x[0], x[0], x[0])),
        ("strided", lambda: K.flash_attention(x.transpose(2, 3), x, x)),
        ("shapes", lambda: K.flash_attention(x, x[:, :1].contiguous(), x)),
        ("block-q-96", lambda: K.flash_attention(x, x, x, block_q=96)),
        ("block-k-2048", lambda: K.flash_attention(x, x, x, block_k=2048)),
        ("block-k-0", lambda: K.flash_attention(x, x, x, block_k=0)),
        ("keep-p", lambda: K.flash_attention(x, x, x, keep_p=2)),
        ("prefetch", lambda: K.flash_attention(x, x, x, q_prefetch=3)),
    ]


@pytest.mark.parametrize("idx", range(10), ids=[c[0] for c in _bad_calls()])
def test_wrapper_rejects_what_the_kernel_does_not_take(idx):
    _, call = _bad_calls()[idx]
    with pytest.raises(ValueError):
        call()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build(K.SOURCE)


def test_the_wrapper_names_a_c_entry_of_its_source():
    source = (common.CSRC_DIR / K.SOURCE).read_text()
    symbol = "repro_attention_f32"
    assert f'extern "C" int {symbol}(' in source
    path = common.library_path(K.SOURCE)
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("attention-") and path.suffix == ".so"
    head = source.split(f"{symbol}(", 1)[1].split(")", 1)[0]
    assert len(head.split(",")) == len(K._ARGTYPES)
    # no library product inside the kernel
    for word in ("cublas", "cudnn", "scaled_dot_product", "matmul"):
        assert word not in source.lower()


# --- (d) the slice as a whole: searchers and the session ----------------------

def _records(spec):
    jb, pb = JB["attention"], PB["attention"]
    jh = jhw.SPECS[spec]
    ph = port_spec(jh)
    jrec = jev.record_space(jb.make_space(),
                            lambda c: jb.workload_fn(c, jb.default_input), jh)
    prec = pev.record_space(pb.make_space(),
                            lambda c: pb.workload_fn(c, pb.default_input), ph)
    return jrec, prec, jh, ph


@pytest.mark.parametrize("name", ["profile", "profile_local", "random"])
def test_search_traces_are_bit_identical(name):
    jrec, prec, jh, ph = _records("tpu_v5e")
    assert np.array_equal(prec.runtimes, jrec.runtimes)
    jmodel = jtu.train_model(jrec, kind="tree", seed=3)
    pmodel = ptu.train_model(prec, kind="tree", seed=3)
    jb, pb = JB["attention"], PB["attention"]

    def run(se, ev_mod, rec, model, cores, bench, hw):
        s = se.make_searcher(name, rec.space, seed=7, model=model,
                             cores=cores)
        ev = ev_mod.CostModelEvaluator(
            rec.space, lambda c: bench.workload_fn(c, bench.default_input),
            hw)
        se.run_search(s, ev, 30)
        return ev.trace, ev.history()

    jt = run(jse, jev, jrec, jmodel, jh.cores, jb, jh)
    pt = run(pse, pev, prec, pmodel, ph.sms, pb, ph)
    assert len(pt[0]) == 30
    assert pt == jt


def test_carried_jax_model_steers_an_identical_tune(tmp_path):
    jb, pb = JB["attention"], PB["attention"]
    jwl = lambda c: jb.workload_fn(c, jb.default_input)  # noqa: E731
    pwl = lambda c: pb.workload_fn(c, pb.default_input)  # noqa: E731
    js = JSession(jb.make_space(), jwl, hw=jhw.TPU_V5E, seed=4)
    js.train(train_hw=jhw.TPU_V4, kind="tree")
    jpath = tmp_path / "jax_model.json"
    js.save_model(str(jpath))
    ppath = tmp_path / "port_model.json"
    ppath.write_text(json.dumps(from_jax_artifact(json.loads(
        jpath.read_text()))))
    phw_ = port_spec(jhw.TPU_V5E)
    ps = PSession(pb.make_space(), pwl, hw=phw_, seed=4,
                  evaluator_factory=lambda sp: pev.CostModelEvaluator(
                      sp, pwl, phw_))
    ps.load_model(str(ppath))
    jr = js.tune(budget=25, searcher="profile",
                 evaluator=jev.CostModelEvaluator(js.space, jwl,
                                                  jhw.TPU_V5E))
    pr = ps.tune(budget=25, searcher="profile")
    assert pr.history == jr.history
    assert pr.best_config == jr.best_config
    assert pr.best_runtime == jr.best_runtime


def test_train_save_load_tune_through_the_cpu_evaluator(tmp_path):
    bench = PB["attention"]
    hw = phw.H100_SXM

    def session(inp):
        return PSession(
            bench.make_space(), lambda c: bench.workload_fn(c, inp), hw=hw,
            evaluator_factory=lambda sp: pev.DeviceKernelEvaluator(
                sp, bench, inp, hw=hw, device="cpu", reps=1, warmup=0))

    trainer = session(pspace.AttentionInput(1, 2, 128, 64))
    train_ev = trainer.make_evaluator()
    trainer.train_on_evaluator(train_ev)
    assert train_ev.device_name == "cpu" and train_ev.steps > 0
    path = trainer.save_model(str(tmp_path / "attention.json"))
    tuner = session(pspace.AttentionInput(1, 1, 96, 128))
    tuner.load_model(path)
    ev = tuner.make_evaluator()
    result = tuner.tune(budget=5, searcher="profile", evaluator=ev)
    assert result.steps == 5 and ev.steps == 5
    assert result.best_config in tuner.space.configs
    assert result.best_runtime > 0
