"""The port's transpose, conv2d, coulomb and nbody against the JAX package:
spaces and workload models number for number under ``counters.TPU_NAMES``,
inputs drawn bit for bit, the wrappers' CPU path (the kernels' plain
versions) against the Pallas kernels in interpret mode and the JAX oracles,
and the searchers and the session on the four spaces.  The CUDA kernels'
own tests are in ``test_torch_gpu.py``.

Tolerances, relative to max |reference|, are those of the JAX package's
kernel tests (``tests/test_kernels.py``): transpose exact, coulomb 5e-4,
nbody 1e-3, conv2d 1e-3; the sums run in another order.  The Pallas conv2d
with looped taps is broken under this jax (``pl.load``, ROADMAP queue 3), so
looped taps are held against ``conv2d_ref`` only."""
import dataclasses
import importlib
import json

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch

from repro.core import evaluate as jev
from repro.core import hwspec as jhw
from repro.core import searcher as jse
from repro.core import tuner as jtu
from repro.kernels.registry import BENCHMARKS as JB
from repro.tuning import TuningSession as JSession
from repro_torch.core import evaluate as pev
from repro_torch.core import hwspec as phw
from repro_torch.core import searcher as pse
from repro_torch.core import tuner as ptu
from repro_torch.kernels import common
from repro_torch.kernels.registry import BENCHMARKS as PB
from repro_torch.tuning import TuningSession as PSession
from repro_torch.tuning import from_jax_artifact
from test_torch_space_costmodel import port_spec, to_tpu

KERNELS = ["transpose", "conv2d", "coulomb", "nbody"]
SPACE_SIZES = {"transpose": 128, "conv2d": 336, "coulomb": 1160,
               "nbody": 336}
REGISTRY_INPUTS = [(k, tag) for k in KERNELS for tag in JB[k].inputs]


def _spaces(kernel):
    return (importlib.import_module(f"repro.kernels.{kernel}.space"),
            importlib.import_module(f"repro_torch.kernels.{kernel}.space"))


def _kernel(kernel):
    return importlib.import_module(f"repro_torch.kernels.{kernel}.kernel")


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _port_input(jinp):
    kernel = type(jinp).__module__.split(".")[2]
    pcls = getattr(_spaces(kernel)[1], type(jinp).__name__)
    return pcls(*dataclasses.astuple(jinp))


# --- (a) spaces and workload models -----------------------------------------

def test_the_registry_lists_the_five_paper_kernels():
    paper = {"conv2d", "coulomb", "matmul", "nbody", "transpose"}
    assert paper <= set(PB)
    assert paper <= set(JB)


def test_the_registry_lists_the_six_kernels():
    # the five paper kernels, and flash attention beside them
    assert list(PB) == ["attention", "conv2d", "coulomb", "matmul", "nbody",
                        "transpose"]
    assert set(PB) <= set(JB)


@pytest.mark.parametrize("kernel", KERNELS)
def test_spaces_are_identical(kernel):
    j, p = JB[kernel].make_space(), PB[kernel].make_space()
    assert len(p) == SPACE_SIZES[kernel]
    assert p.name == j.name
    assert p.configs == j.configs
    assert np.array_equal(p.feature_matrix, j.feature_matrix)
    assert np.array_equal(p.subspace_key_matrix, j.subspace_key_matrix)


def test_coulomb_space_keeps_the_z_by_constraint():
    p = PB["coulomb"].make_space()
    assert all(c["Z_IT"] * c["BY"] <= 512 for c in p)
    assert len(p) < 7 * 5 * 5 * 4 * 2


@pytest.mark.parametrize("kernel", KERNELS)
def test_registry_inputs_are_identical(kernel):
    j, p = JB[kernel], PB[kernel]
    assert list(p.inputs) == list(j.inputs)
    for tag in j.inputs:
        assert dataclasses.astuple(p.inputs[tag]) == \
            dataclasses.astuple(j.inputs[tag])
        assert p.inputs[tag].tag == j.inputs[tag].tag
    assert dataclasses.astuple(p.default_input) == \
        dataclasses.astuple(j.default_input)


@pytest.mark.parametrize("kernel,tag", REGISTRY_INPUTS,
                         ids=[f"{k}-{t}" for k, t in REGISTRY_INPUTS])
def test_workload_fn_equals_jax_under_the_name_map(kernel, tag):
    jinp, pinp = JB[kernel].inputs[tag], PB[kernel].inputs[tag]
    for cfg in JB[kernel].make_space():
        ours = to_tpu(PB[kernel].workload_fn(cfg, pinp))
        theirs = JB[kernel].workload_fn(cfg, jinp)
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12,
                                       atol=0, err_msg=f"{cfg} {k}")


# --- (b) inputs ---------------------------------------------------------------

SMALL = {
    "transpose": ("TransposeInput", (40, 72)),
    "conv2d": ("ConvInput", (24, 40, 5)),
    "coulomb": ("CoulombInput", (8, 12)),
    "nbody": ("NBodyInput", (48,)),
}


@pytest.mark.parametrize("kernel", KERNELS)
def test_make_args_draws_the_jax_packages_arrays(kernel):
    cls, fields = SMALL[kernel]
    jinp = getattr(_spaces(kernel)[0], cls)(*fields)
    ours = PB[kernel].make_args(_port_input(jinp), np.random.default_rng(5),
                                "cpu")
    theirs = JB[kernel].make_args(jinp, np.random.default_rng(5))
    tensors = [o for o in ours if isinstance(o, torch.Tensor)]
    assert len(tensors) == len(theirs)
    for o, t in zip(tensors, theirs):
        assert o.device.type == "cpu" and o.dtype == torch.float32
        assert np.array_equal(o.numpy(), np.asarray(t))
    if kernel == "coulomb":   # the grid size rides in the arguments
        assert ours[1] == jinp.grid_size


# --- (c) the wrappers' CPU path against the Pallas kernels and oracles ------

def _args(kernel, jinp, seed=0):
    """The same arrays for both packages: (port args, JAX args)."""
    ours = PB[kernel].make_args(_port_input(jinp), np.random.default_rng(seed),
                                "cpu")
    theirs = JB[kernel].make_args(jinp, np.random.default_rng(seed))
    return ours, theirs


def _launches_unchanged(kernel, fn):
    wrapper = getattr(_kernel(kernel), kernel)
    before = wrapper.launches
    out = fn()
    assert wrapper.launches == before      # the CPU path launches nothing
    return out


@pytest.mark.parametrize("bm,bn", [(64, 128), (128, 64), (32, 256)])
@pytest.mark.parametrize("m,n", [(128, 128), (200, 264), (96, 512)])
def test_cpu_transpose_is_exact(m, n, bm, bn):
    from repro.kernels.transpose.space import TransposeInput

    ours, theirs = _args("transpose", TransposeInput(m, n))
    pallas = JB["transpose"].run({"BLOCK_M": bm, "BLOCK_N": bn,
                                  "STAGE_OUT": 0}, *theirs, interpret=True)
    oracle = JB["transpose"].ref(*theirs)
    for stage in (0, 1):
        out = _launches_unchanged("transpose", lambda: PB["transpose"].run(
            {"BLOCK_M": bm, "BLOCK_N": bn, "STAGE_OUT": stage}, *ours))
        assert out.shape == (n, m) and out.is_contiguous()
        assert np.array_equal(out.numpy(), np.asarray(pallas))
        assert np.array_equal(out.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("z,chunk", [(2, 16), (4, 8), (8, 64)])
@pytest.mark.parametrize("gs,na", [(16, 32), (16, 40), (8, 16)])
def test_cpu_coulomb_matches_pallas_and_oracle(gs, na, z, chunk):
    from repro.kernels.coulomb.space import CoulombInput

    ours, theirs = _args("coulomb", CoulombInput(gs, na))
    cfg = {"Z_IT": z, "BY": 8, "BX": 128, "ATOM_CHUNK": chunk,
           "ATOMS_IN_SMEM": 0}
    pallas = JB["coulomb"].run(cfg, *theirs, grid_size=gs, interpret=True)
    oracle = JB["coulomb"].ref(*theirs, grid_size=gs)
    for in_smem in (0, 1):
        out = _launches_unchanged("coulomb", lambda: PB["coulomb"].run(
            dict(cfg, ATOMS_IN_SMEM=in_smem), *ours))
        assert out.shape == (gs, gs, gs)
        assert _rel(out.numpy(), pallas) < 5e-4
        assert _rel(out.numpy(), oracle) < 5e-4
    assert _rel(PB["coulomb"].ref(*ours).numpy(), oracle) < 5e-4


@pytest.mark.parametrize("bi,bj", [(64, 64), (128, 32), (32, 128)])
@pytest.mark.parametrize("n", [128, 200, 256])
def test_cpu_nbody_matches_pallas_and_oracle(n, bi, bj):
    from repro.kernels.nbody.space import NBodyInput

    ours, theirs = _args("nbody", NBodyInput(n))
    cfg = {"BLOCK_I": bi, "BLOCK_J": bj, "J_UNROLL": 1, "KEEP_PAIRWISE": 0}
    pallas = JB["nbody"].run(cfg, *theirs, interpret=True)
    oracle = JB["nbody"].ref(*theirs)
    for unroll in (1, 2, 4):
        out = _launches_unchanged("nbody", lambda: PB["nbody"].run(
            dict(cfg, J_UNROLL=unroll), *ours))
        assert out.shape == (n, 4)
        assert bool((out[:, 3] == 0).all())
        assert _rel(out.numpy(), pallas) < 1e-3
        assert _rel(out.numpy(), oracle) < 1e-3
    assert _rel(PB["nbody"].ref(*ours).numpy(), oracle) < 1e-3


def test_nbody_plain_version_chunks_over_i(monkeypatch):
    from repro.kernels.nbody.space import NBodyInput

    K = _kernel("nbody")
    ours, theirs = _args("nbody", NBodyInput(200))
    whole = K.nbody_plain(*ours)
    monkeypatch.setattr(K, "PAIRS_PER_CHUNK", 7 * 200)    # 29 chunks of 7
    chunked = K.nbody_plain(*ours)
    assert _rel(chunked.numpy(), whole.numpy()) < 1e-6
    assert _rel(chunked.numpy(), JB["nbody"].ref(*theirs)) < 1e-3


@pytest.mark.parametrize("by,bx,unroll", [(32, 128, 1), (64, 128, 0)])
@pytest.mark.parametrize("h,w", [(64, 128), (96, 160)])
def test_cpu_conv2d_matches_oracle_and_unrolled_pallas(h, w, by, bx, unroll):
    from repro.kernels.conv2d.space import ConvInput

    ours, theirs = _args("conv2d", ConvInput(h, w, 5))
    cfg = {"BY": by, "BX": bx, "UNROLL_TAPS": unroll, "FILTER_SMEM": 0,
           "DMA_DEPTH": 1}
    oracle = JB["conv2d"].ref(*theirs)
    # the looped-tap Pallas path is broken under this jax (ROADMAP queue 3)
    pallas = (JB["conv2d"].run(cfg, *theirs, interpret=True) if unroll
              else None)
    for fsmem in (0, 1):
        out = _launches_unchanged("conv2d", lambda: PB["conv2d"].run(
            dict(cfg, FILTER_SMEM=fsmem), *ours))
        assert out.shape == (h, w)
        assert _rel(out.numpy(), oracle) < 1e-3
        if pallas is not None:
            assert _rel(out.numpy(), pallas) < 1e-3
    assert _rel(PB["conv2d"].ref(*ours).numpy(), oracle) < 1e-3


# --- wrapper and build guards -------------------------------------------------

def _bad_calls():
    T, C, Q, N = (_kernel(k) for k in KERNELS)
    x = torch.zeros((8, 8))
    img, flt = torch.zeros((8, 8)), torch.zeros((5, 5))
    atoms, bodies = torch.zeros((4, 4)), torch.zeros((16, 4))
    return [
        ("transpose-f64", lambda: T.transpose(x.double()), TypeError),
        ("transpose-3d", lambda: T.transpose(x[None]), ValueError),
        ("transpose-strided", lambda: T.transpose(x.t()), ValueError),
        ("transpose-stage", lambda: T.transpose(x, stage_out=2), ValueError),
        ("conv2d-even", lambda: C.conv2d(img, flt[:4, :4]), ValueError),
        ("conv2d-f64", lambda: C.conv2d(img.double(), flt), TypeError),
        ("conv2d-f33", lambda: C.conv2d(
            img, torch.zeros((33, 33)), unroll_taps=1), ValueError),
        ("conv2d-block", lambda: C.conv2d(img, flt, by=0), ValueError),
        ("coulomb-shape", lambda: Q.coulomb(atoms[:, :3], 8), ValueError),
        ("coulomb-z", lambda: Q.coulomb(atoms, 8, z_it=3), ValueError),
        ("coulomb-chunk", lambda: Q.coulomb(atoms, 8, atom_chunk=4096),
         ValueError),
        ("coulomb-grid", lambda: Q.coulomb(atoms, 0), ValueError),
        ("nbody-shape", lambda: N.nbody(bodies[:, :3]), ValueError),
        ("nbody-block-i", lambda: N.nbody(bodies, block_i=2048), ValueError),
        ("nbody-unroll", lambda: N.nbody(bodies, j_unroll=3), ValueError),
        ("nbody-block-j", lambda: N.nbody(bodies, block_j=30, j_unroll=4),
         ValueError),
    ]


@pytest.mark.parametrize("idx", range(16), ids=[c[0] for c in _bad_calls()])
def test_wrappers_reject_what_the_kernels_do_not_take(idx):
    _, call, err = _bad_calls()[idx]
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_failed_build_raises(kernel, tmp_path, monkeypatch):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build(_kernel(kernel).SOURCE)


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_wrapper_names_a_c_entry_of_its_source(kernel):
    K = _kernel(kernel)
    source = (common.CSRC_DIR / K.SOURCE).read_text()
    symbol = f"repro_{kernel}_f32"
    assert f'extern "C" int {symbol}(' in source
    assert "-gencode" in common.NVCC_FLAGS and \
        "arch=compute_90a,code=sm_90a" in common.NVCC_FLAGS
    path = common.library_path(K.SOURCE)
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith(f"{kernel}-") and path.suffix == ".so"
    # the C entry takes as many arguments as the wrapper passes
    head = source.split(f"{symbol}(", 1)[1].split(")", 1)[0]
    assert len(head.split(",")) == len(K._ARGTYPES)


# --- (d) the slice as a whole: searchers and the session ----------------------

def _records(kernel, spec):
    jb, pb = JB[kernel], PB[kernel]
    jh = jhw.SPECS[spec]
    ph = port_spec(jh)
    jrec = jev.record_space(jb.make_space(),
                            lambda c: jb.workload_fn(c, jb.default_input), jh)
    prec = pev.record_space(pb.make_space(),
                            lambda c: pb.workload_fn(c, pb.default_input), ph)
    return jrec, prec, jh, ph


@pytest.mark.parametrize("name", ["profile", "random"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_search_traces_are_bit_identical(kernel, name):
    jrec, prec, jh, ph = _records(kernel, "tpu_v5e")
    assert np.array_equal(prec.runtimes, jrec.runtimes)
    jmodel = jtu.train_model(jrec, kind="tree", seed=3)
    pmodel = ptu.train_model(prec, kind="tree", seed=3)

    def run(se, ev_mod, rec, model, cores, bench, hw):
        s = se.make_searcher(name, rec.space, seed=7, model=model,
                             cores=cores)
        ev = ev_mod.CostModelEvaluator(
            rec.space, lambda c: bench.workload_fn(c, bench.default_input),
            hw)
        se.run_search(s, ev, 30)
        return ev.trace, ev.history()

    jt = run(jse, jev, jrec, jmodel, jh.cores, JB[kernel], jh)
    pt = run(pse, pev, prec, pmodel, ph.sms, PB[kernel], ph)
    assert len(pt[0]) == 30
    assert pt == jt


@pytest.mark.parametrize("name", ["profile", "random"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_carried_jax_model_steers_an_identical_tune(kernel, name, tmp_path):
    jb, pb = JB[kernel], PB[kernel]
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
    jev_ = jev.CostModelEvaluator(js.space, jwl, jhw.TPU_V5E)
    pev_ = ps.make_evaluator()
    jr = js.tune(budget=25, searcher=name, evaluator=jev_)
    pr = ps.tune(budget=25, searcher=name, evaluator=pev_)
    assert pev_.trace == jev_.trace and pev_.history() == jev_.history()
    assert pr.history == jr.history
    assert pr.best_config == jr.best_config
    assert pr.best_runtime == jr.best_runtime


TINY = {   # (train input, tune input): two inputs where the registry has two
    "transpose": (("TransposeInput", (40, 72)),) * 2,
    "conv2d": (("ConvInput", (24, 40, 5)),) * 2,
    "coulomb": (("CoulombInput", (8, 12)), ("CoulombInput", (6, 9))),
    "nbody": (("NBodyInput", (64,)), ("NBodyInput", (48,))),
}


@pytest.mark.parametrize("kernel", KERNELS)
def test_train_save_load_tune_through_the_cpu_evaluator(kernel, tmp_path):
    bench = PB[kernel]
    hw = phw.H100_SXM
    space_mod = _spaces(kernel)[1]

    def inp(which):
        cls, fields = TINY[kernel][which]
        return getattr(space_mod, cls)(*fields)

    def session(i):
        return PSession(
            bench.make_space(), lambda c: bench.workload_fn(c, i), hw=hw,
            evaluator_factory=lambda sp: pev.DeviceKernelEvaluator(
                sp, bench, i, hw=hw, device="cpu", reps=1, warmup=0))

    trainer = session(inp(0))
    train_ev = trainer.make_evaluator()
    trainer.train_on_evaluator(train_ev)
    assert train_ev.device_name == "cpu" and train_ev.steps > 0
    path = trainer.save_model(str(tmp_path / f"{kernel}.json"))
    tuner = session(inp(1))
    tuner.load_model(path)
    ev = tuner.make_evaluator()
    result = tuner.tune(budget=5, searcher="profile", evaluator=ev)
    assert result.steps == 5 and ev.steps == 5
    assert result.best_config in tuner.space.configs
    assert result.best_runtime > 0
    assert all(0.0 <= v <= 1.0 for v in ev.measured[
        ev.space.index_of(result.best_config)].stress.values())
