"""The port's cross-space transfer path against the JAX package's: space
signatures and similarities of the six registry spaces, the store's
transfer ranking, rebound models and their committee, the transferred warm
start's traces, and the store's persistence (save, load, merge, checksum).

Models are trained on each package's cost model with converted specs
(``port_spec``), so both sides fit identical trees; every comparison is
exact under ``counters.TPU_NAMES``."""
import json
import os

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import evaluate as jev
from repro.core import hwspec as jhw
from repro.core import searcher as jse
from repro.core import tuner as jtu
from repro.kernels.registry import BENCHMARKS as JB
from repro import tuning as JT
from repro_torch.core import counters as PC
from repro_torch.core import evaluate as pev
from repro_torch.core import hwspec as phw
from repro_torch.core import searcher as pse
from repro_torch.core import tuner as ptu
from repro_torch.core.model import TransferEnsemble, TransferredModel
from repro_torch.kernels.registry import BENCHMARKS as PB
from repro_torch import tuning as PT
from test_torch_space_costmodel import port_spec

KERNELS = ["attention", "conv2d", "coulomb", "matmul", "nbody", "transpose"]
SOURCES = ("matmul", "transpose", "nbody", "attention", "coulomb")
HW = "tpu_v5e"
TARGETS = [("conv2d", "4096"), ("attention", "default")]


def _default_tag(bench):
    return next(k for k, v in bench.inputs.items()
                if v is bench.default_input)


def _signature(T, bench):
    sp = bench.make_space()
    counters = sorted(bench.workload_fn(sp[0], bench.default_input))
    return T.SpaceSignature.from_space(sp, kind="kernel", counters=counters)


def _tpu(names):
    return sorted(PC.TPU_NAMES[n] for n in names)


# --- signatures ---------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_signatures_equal_jax_under_the_name_map(kernel):
    j, p = _signature(JT, JB[kernel]), _signature(PT, PB[kernel])
    assert (p.kind, p.space) == (j.kind, j.space)
    assert [s.to_dict() for s in p.slots] == [s.to_dict() for s in j.slots]
    assert _tpu(p.counters) == list(j.counters)
    back = PT.SpaceSignature.from_dict(json.loads(json.dumps(p.to_dict())))
    assert back == p and back.sig_hash == p.sig_hash


@pytest.mark.parametrize("kernel", KERNELS)
def test_signature_from_problem_equals_from_space(kernel):
    bench = PB[kernel]
    problem = PT.make_problem("kernel", f"{kernel}/{_default_tag(bench)}")
    assert PT.SpaceSignature.from_problem(problem) == _signature(PT, bench)


def test_similarities_of_the_six_spaces_equal_jax():
    js = {k: _signature(JT, JB[k]) for k in KERNELS}
    ps = {k: _signature(PT, PB[k]) for k in KERNELS}
    for a in KERNELS:
        for b in KERNELS:
            assert PT.similarity(ps[a], ps[b]) == JT.similarity(js[a], js[b])
            assert PT.transfer_compatible(ps[a], ps[b]) == \
                JT.transfer_compatible(js[a], js[b])
            assert PT.map_parameters(ps[a], ps[b]) == \
                JT.map_parameters(js[a], js[b])
        assert PT.similarity(ps[a], ps[a]) == 1.0
    conv = [PT.similarity(ps["conv2d"], ps[s]) for s in SOURCES]
    assert min(conv) > PT.DEFAULT_TRANSFER_THRESHOLD


def test_transfer_never_crosses_problem_kinds():
    p = _signature(PT, PB["conv2d"])
    other = PT.SpaceSignature(kind="serve", space=p.space, slots=p.slots,
                              counters=p.counters)
    assert PT.similarity(p, other) == 1.0
    assert not PT.transfer_compatible(p, other)


# --- the store's transfer tier ------------------------------------------------

def _corpora(sources=SOURCES):
    """The same corpus in both packages: one tree per source kernel, trained
    on the deliberate sample of its default input's cost-model record."""
    jstore, pstore = JT.ConfigStore(), PT.ConfigStore()
    jh = jhw.SPECS[HW]
    ph = port_spec(jh)
    for kernel in sources:
        for T, B, hw, store in ((JT, JB, jh, jstore), (PT, PB, ph, pstore)):
            bench = B[kernel]
            tag = _default_tag(bench)
            sp = bench.make_space()
            sess = T.TuningSession(
                sp, lambda c, b=bench: b.workload_fn(c, b.default_input),
                hw=hw, seed=0)
            model = sess.train(kind="tree", sample="deliberate")
            store.save_model(sp.name, tag, HW, model, sp, kind="kernel")
    return jstore, pstore


@pytest.fixture(scope="module")
def corpora():
    return _corpora()


@pytest.mark.parametrize("target", TARGETS, ids=lambda t: t[0])
def test_transfer_candidates_rank_as_in_jax(target):
    kernel, bucket = target
    sources = [s for s in KERNELS if s != kernel]
    jstore, pstore = _corpora(sources)
    jc = jstore.transfer_candidates(_signature(JT, JB[kernel]), bucket, HW)
    pc = pstore.transfer_candidates(_signature(PT, PB[kernel]), bucket, HW)
    assert len(pc) == len(sources)
    assert pc == jc


def _ensembles(corpora, kernel, bucket):
    jstore, pstore = corpora
    jsp, psp = JB[kernel].make_space(), PB[kernel].make_space()
    je = jstore.load_transfer_ensemble(_signature(JT, JB[kernel]), bucket, HW,
                                       bind_space=jsp)
    pe = pstore.load_transfer_ensemble(_signature(PT, PB[kernel]), bucket, HW,
                                       bind_space=psp)
    return je, pe


def test_rebound_models_and_committee_predict_as_in_jax(corpora):
    (je, jkey, jsim), (pe, pkey, psim) = _ensembles(corpora, "conv2d",
                                                    "4096")
    assert isinstance(pe, TransferEnsemble) and len(pe) == len(je) == 5
    assert (pkey, psim) == (jkey, jsim)
    assert pe.source_key == pkey and pe.similarity == psim
    for (pm, ps_), (jm, js_) in zip(pe.members, je.members):
        assert isinstance(pm, TransferredModel)
        assert (pm.source_key, ps_) == (jm.source_key, js_)
        assert pm.param_map == jm.param_map
        assert _tpu(pm.counter_names) == sorted(jm.counter_names)
        order = [list(pm.counter_names).index(n) for n in
                 sorted(pm.counter_names, key=lambda n: PC.TPU_NAMES[n])]
        jorder = [list(jm.counter_names).index(n)
                  for n in sorted(jm.counter_names)]
        pmat, jmat = pm.predict_matrix(), jm.predict_matrix()
        assert np.array_equal(pmat[:, order], jmat[:, jorder])
        cfg = pm.space[7]
        assert pm.translate(cfg) == jm.translate(cfg)


@pytest.mark.parametrize("target", TARGETS, ids=lambda t: t[0])
def test_ensemble_scores_and_warm_start_traces_equal_jax(corpora, target):
    kernel, bucket = target
    if kernel == "attention":
        sources = [s for s in KERNELS if s != kernel]
        corpora = _corpora(sources)
    (je, _, _), (pe, _, _) = _ensembles(corpora, kernel, bucket)
    jh = jhw.SPECS[HW]
    ph = port_spec(jh)
    jsp, psp = je.top.space, pe.top.space
    jscore = jtu.ensemble_runtime_scores(je, jsp, jh)
    pscore = ptu.ensemble_runtime_scores(pe, psp, ph)
    assert np.array_equal(pscore, jscore)
    order = [int(i) for i in np.argsort(pscore, kind="stable")]
    jb, pb = JB[kernel], PB[kernel]
    for seed in range(3):
        js = jse.TransferredWarmStart(jsp, order=order, seed=seed)
        ps = pse.TransferredWarmStart(psp, order=order, seed=seed)
        jev_ = jev.CostModelEvaluator(
            jsp, lambda c: jb.workload_fn(c, jb.default_input), jh)
        pev_ = pev.CostModelEvaluator(
            psp, lambda c: pb.workload_fn(c, pb.default_input), ph)
        jse.run_search(js, jev_, 30)
        pse.run_search(ps, pev_, 30)
        assert pev_.trace == jev_.trace and pev_.history() == jev_.history()
        assert ps.trusted == js.trusted is not None


def test_transfer_warm_start_is_registered_and_walks_the_order():
    sp = PB["conv2d"].make_space()
    s = pse.make_searcher("transfer_warm_start", sp, seed=2,
                          order=list(range(10, 20)))
    assert isinstance(s, pse.TransferredWarmStart)
    cold = pse.make_searcher("transfer_warm_start", sp, seed=2)
    rnd = pse.make_searcher("random", sp, seed=2)
    first = [c.index for c in cold.propose(5)]
    assert first == [c.index for c in rnd.propose(5)]


def test_replayed_trials_to_well_equal_jax(corpora):
    """The phase ``chip_smoke.py`` runs on the card, here on cost-model
    records: the transferred and the cold walk's trials to within 1.1x."""
    (je, _, _), (pe, _, _) = _ensembles(corpora, "conv2d", "4096")
    jh = jhw.SPECS[HW]
    ph = port_spec(jh)
    jb, pb = JB["conv2d"], PB["conv2d"]
    jrec = jev.record_space(jb.make_space(),
                            lambda c: jb.workload_fn(c, jb.inputs["4096"]),
                            jh)
    prec = pev.record_space(pb.make_space(),
                            lambda c: pb.workload_fn(c, pb.inputs["4096"]),
                            ph)
    order = [int(i) for i in np.argsort(
        ptu.ensemble_runtime_scores(pe, prec.space, ph), kind="stable")]
    jorder = [int(i) for i in np.argsort(
        jtu.ensemble_runtime_scores(je, jrec.space, jh), kind="stable")]
    assert order == jorder
    for name in ("transfer_warm_start", "random"):
        kw = {"order": order} if name != "random" else {}
        pst = ptu.run_search_experiment(
            lambda seed: pse.make_searcher(name, prec.space, seed=seed, **kw),
            prec, repeats=20, well_factor=1.1)
        jst = jtu.run_search_experiment(
            lambda seed: jse.make_searcher(name, jrec.space, seed=seed,
                                           **kw),
            jrec, repeats=20, well_factor=1.1)
        assert pst.median_steps == jst.median_steps
        assert pst.mean_steps == jst.mean_steps


# --- the store: exact tiers, persistence --------------------------------------

def test_exact_hit_never_consults_the_transfer_tier(corpora, monkeypatch):
    _, pstore = corpora
    store = PT.ConfigStore()
    store._models = dict(pstore._models)
    store._reindex_models()
    ph = port_spec(jhw.SPECS[HW])
    bench = PB["conv2d"]
    sp = bench.make_space()
    sess = PT.TuningSession(sp, lambda c: bench.workload_fn(
        c, bench.inputs["4096"]), hw=ph, seed=0)
    sess.train(kind="tree", sample="deliberate")
    sess.save_model_to_store(store, "4096", hardware=HW, kind="kernel")

    def refuse(*args, **kwargs):
        raise AssertionError("transfer tier consulted on an exact hit")

    monkeypatch.setattr(store, "transfer_candidates", refuse)
    model, key = store.load_nearest_model("conv2d", "4096", HW,
                                          bind_space=sp, kind="kernel")
    assert key == "kernel|conv2d|4096|tpu_v5e"
    assert np.array_equal(model.predict_matrix(),
                          sess.model.predict_matrix())
    again = PT.TuningSession(sp, hw=ph)
    assert again.load_model_from_store(store, "4096", hardware=HW,
                                       kind="kernel") is not None
    assert store.load_nearest_model("conv2d", "nope", "other_hw",
                                    kind="kernel")[1] == key
    assert store.load_nearest_model("conv2d", "4096", HW,
                                    kind="serve") == (None, None)


def test_store_save_load_merge_round_trip(tmp_path):
    path = str(tmp_path / "store.json")
    a, b = PT.ConfigStore(path), PT.ConfigStore(path)
    sp = PB["nbody"].make_space()
    a.put("nbody", "16k", "h100_sxm", sp[0], 1.0e-3, trials=5)
    b.put("nbody", "16k", "h100_sxm", sp[1], 0.5e-3, trials=7)   # better
    b.put("nbody", "131k", "h100_sxm", sp[2], 9e-3, trials=3)
    ph = phw.H100_SXM
    sess = PT.TuningSession(sp, lambda c: PB["nbody"].workload_fn(
        c, PB["nbody"].default_input), hw=ph, seed=0)
    model = sess.train(kind="tree", sample="deliberate")
    a.save_model("nbody", "16k", "h100_sxm", model, sp, kind="kernel")
    a.save()
    b.save()                                   # merges a's writes in
    c = PT.ConfigStore(path)
    assert len(c) == 2
    best = c.get("nbody", "16k", "h100_sxm")
    assert best.config == sp[1] and best.trials == 7
    assert set(c.model_keys()) == {"kernel|nbody|16k|h100_sxm"}
    d = json.loads(open(path).read())
    assert d["format"] == "repro_torch.config_store" and d["version"] == 3
    art = d["models"]["kernel|nbody|16k|h100_sxm"]
    assert art["format"] == "repro_torch.tppc_model"
    assert art["revision"] == 1 and "signature" in art
    loaded = c.load_model("nbody", "16k", "h100_sxm", bind_space=sp)
    assert np.array_equal(loaded.predict_matrix(), model.predict_matrix())
    assert loaded.signature == PT.artifact_signature(art)
    # a newer revision wins a merge; a stale one loses
    c.save_model("nbody", "16k", "h100_sxm", model, sp, kind="kernel")
    assert c.get_model_dict("nbody", "16k", "h100_sxm")["revision"] == 2
    b.save_model("nbody", "16k", "h100_sxm", model, sp, revision=1)
    assert b.get_model_dict("nbody", "16k", "h100_sxm")["revision"] == 2


def test_a_damaged_store_is_quarantined(tmp_path):
    path = str(tmp_path / "store.json")
    s = PT.ConfigStore(path)
    s.put("conv2d", "4096", "h100_sxm", PB["conv2d"].make_space()[0], 1e-4, 1)
    d = json.loads(open(path).read())
    d["entries"]["kernel|conv2d|4096|h100_sxm"]["runtime"] = 5.0
    with open(path, "w") as f:
        json.dump(d, f)                       # checksum no longer matches
    again = PT.ConfigStore(path)
    assert len(again) == 0 and len(again.quarantined) == 1
    assert os.path.exists(path + ".corrupt")


def test_port_refuses_a_jax_store(tmp_path):
    path = str(tmp_path / "jax_store.json")
    js = JT.ConfigStore(path)
    js.put("conv2d", "4096", HW, JB["conv2d"].make_space()[0], 1e-4, 1)
    with pytest.raises(ValueError, match="repro_torch.config_store"):
        PT.ConfigStore(path)


# --- problems -----------------------------------------------------------------

def test_kernel_problems_list_as_in_jax():
    assert PT.problem_kinds() == JT.problem_kinds()
    assert PT.list_problems("kernel") == JT.list_problems("kernel")
    p = PT.parse_problem("kernel:conv2d/4096")
    j = JT.parse_problem("kernel:conv2d/4096")
    assert (p.kind, p.name, p.bucket, p.spec) == (j.kind, j.name, j.bucket,
                                                  j.spec)
    assert p.describe() == j.describe()
    assert p.make_evaluator(phw.H100_SXM) is None
    assert to_tpu_dict(p.workload_fn()(p.space()[3])) == \
        j.workload_fn()(j.space()[3])
    assert PT.make_problem("sharding", "qwen2.5-3b/train_4k").spec == \
        JT.make_problem("sharding", "qwen2.5-3b/train_4k").spec
    with pytest.raises(ValueError):
        PT.parse_problem("conv2d")
    with pytest.raises(KeyError):
        PT.make_problem("kernel", "conv2d/8192")


def to_tpu_dict(d):
    return {PC.TPU_NAMES[k]: v for k, v in d.items()}
