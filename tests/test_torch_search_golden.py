"""The port's expert system, searchers and session against the JAX
package's: identical bottleneck and ΔPC vectors under the counter map, and
bit-identical search traces on converted specs."""
import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest
import torch  # noqa: F401

from repro.core import bottleneck as jb
from repro.core import evaluate as jev
from repro.core import hwspec as jhw
from repro.core import reaction as jre
from repro.core import searcher as jse
from repro.core import tuner as jtu
from repro.kernels.matmul import space as jspace
from repro.tuning import TuningSession as JSession
from repro_torch.core import bottleneck as pb
from repro_torch.core import counters as PC
from repro_torch.core import evaluate as pev
from repro_torch.core import reaction as pre
from repro_torch.core import searcher as pse
from repro_torch.core import tuner as ptu
from repro_torch.kernels.matmul import space as pspace
from repro_torch.tuning import TuningSession as PSession
from test_torch_space_costmodel import port_spec

SEARCHERS = ["profile", "profile_local", "random", "basin_hopping",
             "starchart"]


def _records(spec, inp_name="DEFAULT_INPUT"):
    ji, pi = getattr(jspace, inp_name), getattr(pspace, inp_name)
    jh = jhw.SPECS[spec]
    ph = port_spec(jh)
    jrec = jev.record_space(jspace.make_space(ji),
                            lambda c: jspace.workload_fn(c, ji), jh)
    prec = pev.record_space(pspace.make_space(pi),
                            lambda c: pspace.workload_fn(c, pi), ph)
    return jrec, prec, jh, ph


@pytest.mark.parametrize("spec,inp", [("tpu_v4", "DEFAULT_INPUT"),
                                      ("tpu_v5e", "RECT_TALL"),
                                      ("tpu_v6e", "SQUARE_SMALL")])
def test_analyze_and_delta_pc_equal_jax(spec, inp):
    jrec, prec, jh, ph = _records(spec, inp)
    assert len(pb.ALL_BOTTLENECKS) == len(jb.ALL_BOTTLENECKS)
    for jcs, pcs in zip(jrec.counters, prec.counters):
        jbv = jb.analyze(jcs, cores=jh.cores)
        pbv = pb.analyze(pcs, cores=ph.sms)
        assert [pbv[k] for k in pb.ALL_BOTTLENECKS] == \
            [jbv[k] for k in jb.ALL_BOTTLENECKS]
        jd = jre.compute_delta_pc(jbv)
        pd = pre.compute_delta_pc(pbv)
        assert {PC.TPU_NAMES[k]: v for k, v in pd.items()} == jd
        assert list(pd) == list(PC.PC_OPS)


@pytest.mark.parametrize("name", SEARCHERS)
def test_search_traces_are_bit_identical(name):
    jrec, prec, jh, ph = _records("tpu_v5e")
    jmodel = jtu.train_model(jrec, kind="tree", seed=3)
    pmodel = ptu.train_model(prec, kind="tree", seed=3)

    def run(se, ev_mod, rec, model, cores, workload, hw):
        ctx = dict(model=model, cores=cores)
        s = se.make_searcher(name, rec.space, seed=7, **ctx)
        ev = ev_mod.CostModelEvaluator(rec.space, workload, hw)
        se.run_search(s, ev, 30)
        return ev.trace, ev.history()

    jt = run(jse, jev, jrec, jmodel, jh.cores,
             lambda c: jspace.workload_fn(c, jspace.DEFAULT_INPUT), jh)
    pt = run(pse, pev, prec, pmodel, ph.sms,
             lambda c: pspace.workload_fn(c, pspace.DEFAULT_INPUT), ph)
    assert len(pt[0]) == 30
    assert pt == jt


@pytest.mark.parametrize("searcher", ["profile", "random"])
def test_session_train_and_tune_give_the_same_best(searcher):
    ji, pi = jspace.RECT_TALL, pspace.RECT_TALL
    js = JSession(jspace.make_space(ji), lambda c: jspace.workload_fn(c, ji),
                  hw=jhw.TPU_V5E, seed=2)
    pwl = lambda c: pspace.workload_fn(c, pi)  # noqa: E731
    phw = port_spec(jhw.TPU_V5E)
    ps = PSession(pspace.make_space(pi), pwl, hw=phw, seed=2,
                  evaluator_factory=lambda sp: pev.CostModelEvaluator(sp, pwl,
                                                                      phw))
    js.train(train_hw=jhw.TPU_V4)
    ps.train(train_hw=port_spec(jhw.TPU_V4))
    jr = js.tune(budget=20, searcher=searcher)
    pr = ps.tune(budget=20, searcher=searcher)
    assert pr.best_config == jr.best_config
    assert pr.best_runtime == jr.best_runtime
    assert pr.history == jr.history


def test_port_session_has_no_default_evaluator():
    pi = pspace.RECT_TALL
    ps = PSession(pspace.make_space(pi), lambda c: pspace.workload_fn(c, pi),
                  hw=port_spec(jhw.TPU_V5E), seed=2)
    ps.train(train_hw=port_spec(jhw.TPU_V4))
    with pytest.raises(ValueError, match="evaluator_factory"):
        ps.tune(budget=5)
    with pytest.raises(ValueError, match="evaluator_factory"):
        ps.make_evaluator()


def test_replay_experiment_statistics_equal_jax():
    jrec, prec, jh, ph = _records("tpu_v4")
    jmodel = jtu.train_model(jrec, kind="tree")
    pmodel = ptu.train_model(prec, kind="tree")
    js = jtu.run_search_experiment(
        lambda s: jse.ProfileBasedSearcher(jrec.space, model=jmodel,
                                           cores=jh.cores, seed=s),
        jrec, repeats=10)
    ps = ptu.run_search_experiment(
        lambda s: pse.ProfileBasedSearcher(prec.space, model=pmodel,
                                           cores=ph.sms, seed=s),
        prec, repeats=10)
    assert ps.steps_to_well == js.steps_to_well
    assert ps.times_to_well == js.times_to_well
