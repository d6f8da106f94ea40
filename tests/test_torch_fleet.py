"""The port's fleet (``repro_torch.fleet``, ``repro_torch.launch.fleet``)
against the JAX package's (``repro.fleet``).

The cases of ``tests/test_fleet.py`` and ``tests/test_fleet_faults.py``,
each run through BOTH fleets on the same jobs: the JAX package's on its
registered TPU specs, the port's on those specs converted field by field
(``port_spec``).  On ``VirtualWorkerPool`` the two must give the same
per-job traces, histories, best indices, searchers, warm-start tiers,
known-bad lists and parked flags, bit for bit, and the same store contents
once the hardware keys are mapped: a converted spec is not registered in
the port, so its key is its fingerprint (``tpu_v4`` → ``tpu_v4-275tf-
1228gbs``, which is the JAX package's own fingerprint of the spec).  The
serving jobs of the JAX tests become kernel jobs here: the port has no
serving autotuner yet.

Beside parity: subprocess lanes on the CPU (handshake, cost-model replies
equal to the JAX worker's, ``sim_fail``/``sim_crash``), a job measured
through ``DeviceKernelEvaluator(device="cpu")`` on a ``ThreadWorkerPool``,
the measuring pool's one-lane-a-card rule, lanes that never price in place
of measuring, and the CLI.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.fleet as jfleet
import repro_torch.fleet as pfleet
from repro.core import account as jacc
from repro.core import evaluate as jev
from repro.core import hwspec as jhw
from repro.core import searcher as jse
from repro.core import tuner as jtu
from repro.kernels.registry import BENCHMARKS as JB
from repro.tuning import ConfigStore as JStore
from repro_torch.core import account as pacc
from repro_torch.core import counters as PC
from repro_torch.core import evaluate as pev
from repro_torch.core import hwspec as phw
from repro_torch.core import searcher as pse
from repro_torch.core import tuner as ptu
from repro_torch.fleet import worker_main as pworker
from repro_torch.kernels.registry import BENCHMARKS as PB
from repro_torch.tuning import ConfigStore as PStore
from repro_torch.tuning import from_jax_artifact
from test_torch_space_costmodel import port_spec

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# a registered TPU name -> the port's store key of its converted spec
KEYS = {n: phw.hardware_key(port_spec(s)) for n, s in jhw.SPECS.items()}


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's fleet and what a scenario needs of it."""

    name: str
    fleet: types.ModuleType
    Store: type
    ev: types.ModuleType
    se: types.ModuleType
    tu: types.ModuleType
    acc: types.ModuleType
    bench: object
    tuner_path: str
    port: bool

    def hw(self, name):
        """A job's ``hardware`` for TPU spec ``name``."""
        return port_spec(jhw.SPECS[name]) if self.port else name

    def spec(self, name):
        return port_spec(jhw.SPECS[name]) if self.port else jhw.SPECS[name]

    def key(self, name):
        return KEYS[name] if self.port else name

    def cores(self, spec):
        return spec.sms if self.port else spec.cores


JAX = Side("jax", jfleet, JStore, jev, jse, jtu, jacc, JB,
           "repro.fleet.tuner", False)
PORT = Side("port", pfleet, PStore, pev, pse, ptu, pacc, PB,
            "repro_torch.fleet.tuner", True)


# --- comparison under the hardware-key map -----------------------------------

def _map_key(s):
    """A JAX-side name, store key or job name, in the port's hardware keys."""
    if s is None:
        return None
    for name, key in KEYS.items():
        if s == name:
            return key
        for sep in ("@", "|"):
            if s.endswith(sep + name):
                return s[:-len(name)] + key
    return s


RESULT_FIELDS = ("bucket", "searcher", "warm_started", "best_index",
                 "best_config", "best_runtime", "trials", "busy",
                 "failures", "abandoned_s", "known_bad", "parked",
                 "cancelled", "transfer_similarity")
REPORT_FIELDS = ("busy", "in_flight", "workers", "abandoned", "failures",
                 "timeouts", "known_bad", "parked", "max_retries_used",
                 "in_flight_max")


def assert_same_results(jres, pres, clock=True):
    """Every field of every job equal.  ``clock=False`` leaves out when
    each test finished on the virtual clock (the traces' elapsed column,
    ``elapsed``) and the order of completions: when several jobs wait on
    warm-start predictions on the trainer thread, which one binds first
    depends on that thread's timing, in the JAX fleet as in the port's
    (the same scenario run twice on one fleet differs there); what each
    job measured, and the store, do not."""
    assert len(pres) == len(jres)
    for j, p in zip(jres, pres):
        assert p.job == _map_key(j.job)
        assert p.hardware == _map_key(j.hardware)
        for f in RESULT_FIELDS:
            assert getattr(p, f) == getattr(j, f), (j.job, f)
        assert p.transfer_from == _map_key(j.transfer_from)
        if clock:
            assert (p.trace, p.history, p.elapsed) == \
                (j.trace, j.history, j.elapsed), j.job
        else:
            assert sorted(p.history) == sorted(j.history), j.job
            assert [s for s, _, _ in p.trace] == [s for s, _, _ in j.trace]


def assert_same_reports(jrep, prep, clock=True):
    assert_same_results(jrep.results, prep.results, clock)
    for f in REPORT_FIELDS:
        assert getattr(prep, f) == getattr(jrep, f), f
    if clock:
        assert prep.elapsed == jrep.elapsed


def _mapped_entry(e):
    e = dict(e, hardware=_map_key(e["hardware"]))
    meta = dict(e.get("meta") or {})
    if "job" in meta:
        meta["job"] = _map_key(meta["job"])
    if "transfer_from" in meta:
        meta["transfer_from"] = _map_key(meta["transfer_from"])
    e["meta"] = meta
    return e


def assert_same_store(jstore, pstore):
    """Entries equal under the key map; each JAX model artifact, converted
    to the port's counter names, equal to the port's."""
    jd, pd = jstore.to_dict(), pstore.to_dict()
    assert {_map_key(k): _mapped_entry(v)
            for k, v in jd["entries"].items()} == pd["entries"]
    assert sorted(_map_key(k) for k in jd["models"]) == sorted(pd["models"])
    for k, art in jd["models"].items():
        ours = {f: v for f, v in pd["models"][_map_key(k)].items()
                if f != "signature"}
        assert from_jax_artifact(art) == ours, k


def both(scenario, *args, **kwargs):
    """Run ``scenario(side, ...)`` on the JAX fleet and on the port's."""
    return scenario(JAX, *args, **kwargs), scenario(PORT, *args, **kwargs)


# --- jobs ----------------------------------------------------------------------

# the serving buckets of the JAX tests become three kernel jobs: two
# buckets of the GEMM space and conv2d
KERNEL_JOBS = (("matmul", "128"), ("matmul", "2048"), ("conv2d", "4096"))


def _kernel_jobs(S, hw, budget=25, seed=7, searcher=None):
    return [S.fleet.job_from_registry(k, i, S.hw(hw), budget=budget,
                                      seed=seed, searcher=searcher)
            for k, i in KERNEL_JOBS]


def _gemm(S):
    bm = S.bench["matmul"]
    return bm.make_space(), (lambda c: bm.workload_fn(c, bm.inputs["128"]))


def _gemm_recorded(S, hw="tpu_v5e", inp="128"):
    bm = S.bench["matmul"]
    return S.ev.record_space(bm.make_space(),
                             lambda c: bm.workload_fn(c, bm.inputs[inp]),
                             S.spec(hw))


def _eval_fn_job(S, name, eval_fn, budget, seed):
    space, _ = _gemm(S)
    return S.fleet.TuningJob(name=name, space=space, workload_fn=None,
                             hardware=S.hw("tpu_v4"), budget=budget,
                             seed=seed, searcher="random", eval_fn=eval_fn)


def _recording_pool(S, **kw):
    class RecordingPool(S.fleet.VirtualWorkerPool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.items = []
            self.max_out = 0

        def submit(self, item):
            self.items.append(item)
            super().submit(item)
            self.max_out = max(self.max_out, self.outstanding())

    return RecordingPool(**kw)


# =============================================================================
# Golden: the event-driven driver against the sequential one
# =============================================================================
@pytest.mark.parametrize("name", sorted(pse.SEARCHERS))
def test_async_driver_golden_vs_sequential(name):
    """Every registered searcher: the port's event-driven driver at
    in_flight=1 replays its sequential driver, and both replay the JAX
    package's trace."""
    traces = []
    for S in (JAX, PORT):
        rec = _gemm_recorded(S)
        model = S.tu.train_model(rec, kind="exact")
        ctx = dict(model=model, cores=S.cores(S.spec("tpu_v5e")))
        s_seq = S.se.make_searcher(name, rec.space, seed=3, **ctx)
        s_evt = S.se.make_searcher(name, rec.space, seed=3, **ctx)
        ev_seq, ev_evt = S.ev.ReplayEvaluator(rec), S.ev.ReplayEvaluator(rec)
        S.se.sequential_run_search(s_seq, ev_seq, 40)
        S.se.run_search(s_evt, ev_evt, 40, in_flight=1)
        assert ev_evt.trace == ev_seq.trace
        assert ev_evt.history() == ev_seq.history()
        assert ev_evt.best_index == ev_seq.best_index
        assert ev_evt.elapsed == ev_seq.elapsed
        traces.append(ev_evt.trace)
    assert traces[1] == traces[0]


def test_run_search_rejects_bad_in_flight():
    rec = _gemm_recorded(PORT)
    s = pse.make_searcher("random", rec.space, seed=0)
    with pytest.raises(ValueError):
        pse.run_search(s, pev.ReplayEvaluator(rec), 10, in_flight=0)


def test_run_search_in_flight_respects_budget():
    def run(S):
        rec = _gemm_recorded(S)
        ev = S.ev.VirtualAsyncEvaluator(S.ev.ReplayEvaluator(rec), workers=4)
        s = S.se.make_searcher("random", rec.space, seed=2)
        S.se.run_search(s, ev, 17, in_flight=4)
        assert ev.steps == 17 and ev.outstanding() == 0
        return ev.trace

    jt, pt = both(run)
    assert pt == jt


def test_account_records_completion_order():
    acct = pacc.EvalAccount()
    acct.record_completion(5, 3.0, cost=3.0, finished_at=3.0)
    acct.record_completion(4, 1.0, cost=9.0, finished_at=4.0)
    assert acct.steps == 2
    assert acct.elapsed == 4.0                 # completion frontier, not sum
    assert acct.busy == 12.0                   # worker-seconds ARE the sum
    assert acct.trace == [(1, 3.0, 3.0), (2, 4.0, 1.0)]
    assert acct.best_index == 4


def test_virtual_async_out_of_order():
    """A cheap config submitted after an expensive one finishes first."""
    rec = _gemm_recorded(PORT)
    ev = pev.VirtualAsyncEvaluator(pev.ReplayEvaluator(rec), workers=2)
    slow, fast = int(np.argmax(rec.runtimes)), int(np.argmin(rec.runtimes))
    ev.submit([pacc.Candidate(slow), pacc.Candidate(fast)])
    assert ev.collect()[0].index == fast and ev.collect()[0].index == slow
    times = [t for _, t, _ in ev.trace]
    assert times == sorted(times) and ev.elapsed < ev.busy


def test_virtual_async_single_worker_matches_sequential():
    rec = _gemm_recorded(PORT)
    ev_async = pev.VirtualAsyncEvaluator(pev.ReplayEvaluator(rec), workers=1)
    ev_seq = pev.ReplayEvaluator(rec)
    for idx in (3, 11, 7):
        ev_async.submit([pacc.Candidate(idx)])
        ev_async.collect()
        ev_seq.measure(idx)
    assert ev_async.trace == ev_seq.trace
    assert ev_async.elapsed == ev_seq.elapsed


def test_default_shim_submit_collect_matches_measure_many():
    rec = _gemm_recorded(PORT)
    ev_a, ev_b = pev.ReplayEvaluator(rec), pev.ReplayEvaluator(rec)
    cands = [pacc.Candidate(2), pacc.Candidate(9), pacc.Candidate(4)]
    ev_a.submit(cands)
    assert ev_a.collect() == ev_b.measure_many(cands)
    assert ev_a.trace == ev_b.trace and ev_a.outstanding() == 0


# =============================================================================
# Fleet orchestration
# =============================================================================
def _threshold(S, kernel, inp, hw):
    bm = S.bench[kernel]
    rec = S.ev.record_space(bm.make_space(),
                            lambda c: bm.workload_fn(c, bm.inputs[inp]),
                            S.spec(hw))
    return rec.best_runtime * 1.1


@pytest.mark.parametrize("train_async", [False, True],
                         ids=["inline-training", "trainer-thread"])
def test_fleet_shares_store_and_warm_starts(tmp_path, train_async):
    """3 jobs × 2 hardware targets, one store: wave 2 warm-starts from the
    wave-1 artifacts, on both fleets, with the same traces and the same
    store (entries and trained models) under the key map.  With the model
    work on the trainer thread, wave 2's three warm-start predictions race
    it, so the clock is left out of the comparison there."""
    def run(S):
        store = S.Store(str(tmp_path / f"{S.name}{train_async}.json"))
        pool = S.fleet.VirtualWorkerPool(workers=4)
        reps = [S.fleet.FleetTuner(_kernel_jobs(S, hw), pool, store=store,
                                   in_flight=4,
                                   train_async=train_async).run()
                for hw in ("tpu_v4", "tpu_v5e")]
        assert all(not r.warm_started for r in reps[0].results)
        assert all(r.warm_started for r in reps[1].results)
        assert len(store) == 6
        cold = warm = 0
        for hw, rep in zip(("tpu_v4", "tpu_v5e"), reps):
            for (k, inp), r in zip(KERNEL_JOBS, rep.results):
                t = r.trials_to_threshold(_threshold(S, k, inp, hw))
                if r.warm_started:
                    assert t is not None
                    warm += t
                else:             # a cold job that never got there: 26
                    cold += r.trials + 1 if t is None else t
        assert warm <= cold / 2               # the amortization claim
        again = S.Store(str(tmp_path / f"{S.name}{train_async}.json"))
        assert again.get("gemm", "128", S.key("tpu_v4")) is not None
        assert again.get("gemm", "128", S.key("tpu_v5e")) is not None
        return reps, store

    (jreps, jstore), (preps, pstore) = both(run)
    for j, p in zip(jreps, preps):
        assert_same_reports(j, p, clock=not train_async)
    assert_same_store(jstore, pstore)
    # each wave-2 job walked its own space's wave-1 artifact
    for job, r in zip(KERNEL_JOBS, preps[1].results):
        assert r.warm_from.endswith(f"|{KEYS['tpu_v4']}")
        assert r.warm_from.split("|")[1] == PB[job[0]].space().name


def test_fleet_wall_clock_beats_sequential():
    """Same jobs, same budgets: 4 workers compress the virtual wall-clock."""
    def run(S, workers):
        jobs = _kernel_jobs(S, "tpu_v4", budget=20, searcher="random")
        return S.fleet.FleetTuner(jobs, S.fleet.VirtualWorkerPool(workers),
                                  store=None, in_flight=workers,
                                  publish_models=False).run()

    jseq, pseq = both(run, 1)
    jfl, pfl = both(run, 4)
    assert_same_reports(jseq, pseq)
    assert_same_reports(jfl, pfl)
    assert abs(pseq.busy - pfl.busy) < 1e-9
    assert pfl.elapsed < pseq.elapsed / 2


def test_fleet_thread_pool_runs():
    """ThreadWorkerPool end-to-end with a blocking eval_fn, on both."""
    def eval_fn(index, profile):
        time.sleep(0.002)
        return 0.001 * (index + 1), None, 0.002

    def run(S):
        jobs = [_eval_fn_job(S, f"j{i}", eval_fn, 6, i) for i in range(3)]
        pool = S.fleet.ThreadWorkerPool(workers=4)
        try:
            rep = S.fleet.FleetTuner(jobs, pool, store=None,
                                     publish_models=False).run()
        finally:
            pool.close()
        assert sorted(r.trials for r in rep.results) == [6, 6, 6]
        for r in rep.results:
            assert r.best_runtime == min(rt for _, rt in r.history)
        return rep

    jrep, prep = both(run)
    # the searchers draw the same configs; completion order is the threads'
    for j, p in zip(jrep.results, prep.results):
        assert sorted(p.history) == sorted(j.history)


def test_fleet_rejects_duplicate_job_names():
    for S in (JAX, PORT):
        jobs = _kernel_jobs(S, "tpu_v4")[:1] * 2
        with pytest.raises(ValueError):
            S.fleet.FleetTuner(jobs, S.fleet.VirtualWorkerPool(1))


def test_fleet_schedules_jobs_round_robin():
    """The first fill wave spreads lanes across jobs, on both fleets."""
    def run(S):
        pool = _recording_pool(S, workers=4)
        jobs = _kernel_jobs(S, "tpu_v4", budget=8, searcher="random")
        S.fleet.FleetTuner(jobs, pool, store=None, in_flight=4,
                           publish_models=False).run()
        names = [j.name for j in jobs]
        assert [it.job for it in pool.items[:4]] == \
            [names[0], names[1], names[2], names[0]]
        return [(_map_key(it.job), it.index) for it in pool.items]

    jitems, pitems = both(run)
    assert pitems == jitems


def test_fleet_job_results_use_run_relative_clock():
    def run(S):
        pool = S.fleet.VirtualWorkerPool(workers=4)
        S.fleet.FleetTuner(_kernel_jobs(S, "tpu_v4", budget=10), pool,
                           store=None, publish_models=False).run()
        rep2 = S.fleet.FleetTuner(_kernel_jobs(S, "tpu_v5e", budget=10),
                                  pool, store=None,
                                  publish_models=False).run()
        for r in rep2.results:
            assert 0.0 < r.elapsed <= rep2.elapsed + 1e-12
            assert all(0.0 <= t <= rep2.elapsed + 1e-12
                       for _, t, _ in r.trace)
        return rep2

    assert_same_reports(*both(run))


def test_fleet_incremental_loop_matches_run():
    """``run()`` is exactly begin + step-until-idle + finish, on both."""
    def run(S, incremental):
        tuner = S.fleet.FleetTuner(_kernel_jobs(S, "tpu_v4", budget=12),
                                   S.fleet.VirtualWorkerPool(workers=4),
                                   store=None, publish_models=False,
                                   in_flight=4)
        if not incremental:
            return tuner.run()
        tuner.begin()
        while tuner.step():
            pass
        return tuner.finish()

    jrun, prun = both(run, False)
    jinc, pinc = both(run, True)
    assert_same_reports(jrun, prun)
    assert_same_reports(jinc, pinc)
    assert_same_reports(jrun, pinc)       # incremental == run


def test_fleet_add_job_while_running():
    """A fleet starts empty and takes jobs mid-flight."""
    def run(S):
        done = []
        tuner = S.fleet.FleetTuner(
            [], S.fleet.VirtualWorkerPool(workers=2), store=None,
            publish_models=False, allow_empty=True,
            on_job_done=lambda r: done.append(r.job))
        tuner.begin()
        jobs = _kernel_jobs(S, "tpu_v4", budget=6)
        tuner.add_job(jobs[0])
        for _ in range(4):
            tuner.step(max_wait=0.01)
        tuner.add_job(jobs[1])          # injected while job 0 is in flight
        while tuner.step(max_wait=0.01):
            pass
        rep = tuner.finish()
        assert sorted(done) == sorted(j.name for j in jobs[:2])
        assert all(not r.cancelled and r.trials == 6 for r in rep.results)
        with pytest.raises(ValueError):
            tuner.add_job(jobs[0])
        return rep

    assert_same_reports(*both(run))


def test_fleet_cancel_job_mid_run(tmp_path):
    """Cancelling abandons in-flight tests, bills their cost, resolves a
    partial ``cancelled`` result and publishes nothing for that job."""
    def run(S):
        store = S.Store(str(tmp_path / f"{S.name}.json"))
        jobs = _kernel_jobs(S, "tpu_v4", budget=20)[:2]
        tuner = S.fleet.FleetTuner(jobs, S.fleet.VirtualWorkerPool(2),
                                   store=store, in_flight=2)
        tuner.begin()
        for _ in range(3):
            tuner.step(max_wait=0.01)
        assert tuner.cancel_job(jobs[0].name)
        assert not tuner.cancel_job(jobs[0].name)
        assert not tuner.cancel_job("no_such_job")
        while tuner.step(max_wait=0.01):
            pass
        rep = tuner.finish()
        by = rep.by_job()
        assert by[jobs[0].name].cancelled and by[jobs[0].name].trials < 20
        assert not by[jobs[1].name].cancelled
        assert by[jobs[1].name].trials == 20
        assert store.get("gemm", "2048", S.key("tpu_v4")) is not None
        assert store.get("gemm", "128", S.key("tpu_v4")) is None
        return rep, store

    (jrep, jstore), (prep, pstore) = both(run)
    assert_same_reports(jrep, prep)
    assert_same_store(jstore, pstore)


def test_fleet_stop_drains_in_flight():
    def run(S):
        tuner = S.fleet.FleetTuner(_kernel_jobs(S, "tpu_v4", budget=40),
                                   S.fleet.VirtualWorkerPool(workers=4),
                                   store=None, publish_models=False,
                                   in_flight=4)
        tuner.begin()
        tuner.step(max_wait=0.01)
        assert not tuner.stopping
        tuner.stop()
        assert tuner.stopping
        while tuner.step(max_wait=0.01):
            pass
        rep = tuner.finish()
        assert all(r.cancelled and r.trials < 40 for r in rep.results)
        assert 0 < sum(r.trials for r in rep.results) <= 8
        assert rep.busy > 0.0
        return rep

    assert_same_reports(*both(run))


def test_fleet_progress_snapshot():
    def run(S):
        tuner = S.fleet.FleetTuner(_kernel_jobs(S, "tpu_v4", budget=6),
                                   S.fleet.VirtualWorkerPool(workers=2),
                                   store=None, publish_models=False)
        tuner.begin()
        p0 = tuner.progress()
        assert p0["jobs"] == 3 and p0["jobs_done"] == 0
        while tuner.step(max_wait=0.01):
            pass
        tuner.finish()
        p1 = tuner.progress()
        assert p1["jobs_done"] == 3
        assert p1["busy_s"] > 0.0 and 0.0 < p1["utilization"] <= 1.0
        return p0, p1

    assert both(run)[0] == both(run)[1]


def test_unregistered_hardware_ships_spec_payload():
    """Fingerprint keys can't be resolved by name in a worker, so payloads
    carry the spec's numbers; registered hardware travels by name."""
    from repro_torch.fleet.tuner import _JobState

    custom = dataclasses.replace(phw.H100_SXM, name="lab_card")
    job = pfleet.job_from_registry("matmul", "128", "h100_sxm", budget=4)
    job.hardware = custom
    payload = _JobState(job).payload_for(0, False)
    assert "hw" not in payload and "measure" not in payload
    assert phw.HardwareSpec(**payload["hw_spec"]) == custom
    js2 = _JobState(pfleet.job_from_registry("matmul", "128", "H100-SXM",
                                             budget=4))
    assert js2.payload_for(0, False)["hw"] == "h100_sxm"


# =============================================================================
# Hardware naming drift / fingerprint keys
# =============================================================================
DRIFT = ["My GPU (rev B)", "  lab--card  ", "X", "", "TPU v9", "h100 nvl"]


@pytest.mark.parametrize("name", DRIFT)
def test_normalize_name_matches_jax_on_unregistered_names(name):
    assert phw.normalize_name(name) == jhw.normalize_name(name)
    assert phw.hardware_key(name) == jhw.hardware_key(name)


def test_hwspec_get_tolerates_naming_drift():
    for drift in ("H100-SXM", "h100sxm", "H100_SXM", "h100 sxm"):
        assert phw.get(drift) is phw.H100_SXM
    assert phw.get("H100 PCIe") is phw.H100_PCIE
    with pytest.raises(KeyError):
        phw.get("gtx_9000")
    with pytest.raises(KeyError):   # the port registers no TPU
        phw.get("TPUv4")


def test_hardware_key_normalizes():
    assert phw.hardware_key("H100-SXM") == "h100_sxm"
    assert phw.hardware_key(phw.H100_SXM) == "h100_sxm"
    assert phw.hardware_key("h100_pcie") == phw.hardware_key("H100-PCIe")


@pytest.mark.parametrize("name", sorted(jhw.SPECS))
def test_fingerprint_of_a_converted_spec_is_the_jax_fingerprint(name):
    """A TPU spec converted field by field is unregistered in the port: its
    key is its fingerprint, the same string as the JAX package's."""
    ours = port_spec(jhw.SPECS[name])
    assert phw.fingerprint(ours) == jhw.fingerprint(jhw.SPECS[name])
    assert phw.hardware_key(ours) == phw.fingerprint(ours) == KEYS[name]
    custom = dataclasses.replace(jhw.SPECS[name], name="lab_chip")
    assert phw.hardware_key(port_spec(custom)) == jhw.hardware_key(custom)


def test_store_hits_survive_naming_drift(tmp_path):
    store = PStore(str(tmp_path / "s.json"))
    store.put("sp", "b", phw.hardware_key("H100-SXM"), config={"X": 1},
              runtime=1.0, trials=3)
    assert store.get("sp", "b", phw.hardware_key("h100_sxm")) is not None
    assert store.get("sp", "b", phw.hardware_key(phw.H100_SXM)) is not None


def test_nearest_model_preference_order():
    answers = []
    for S in (JAX, PORT):
        rec = _gemm_recorded(S)
        model = S.tu.train_model(rec, kind="tree")
        space = rec.space
        store = S.Store()
        store.save_model(space.name, "bucketA", "hw1", model, space)
        store.save_model(space.name, "bucketB", "hw2", model, space)
        got = [store.nearest_model_key(space.name, b, h)
               for b, h in (("bucketA", "hw1"), ("bucketA", "hw2"),
                            ("bucketC", "hw2"), ("bucketC", "hw9"))]
        assert got == [f"kernel|{space.name}|bucketA|hw1",
                       f"kernel|{space.name}|bucketA|hw1",
                       f"kernel|{space.name}|bucketB|hw2",
                       f"kernel|{space.name}|bucketA|hw1"]
        assert store.nearest_model_key("other_space", "b", "h") is None
        m, key = store.load_nearest_model(space.name, "bucketA", "hw2",
                                          bind_space=space)
        assert m is not None and key.endswith("bucketA|hw1")
        answers.append(got)
    assert answers[0] == answers[1]


# =============================================================================
# Fault tolerance: retries, known-bad, lane kills, stragglers
# =============================================================================
@pytest.mark.parametrize("name", sorted(pse.SEARCHERS))
def test_retry_enabled_zero_failures_bit_identical(name):
    """Failure handling costs nothing when nothing fails: the fleet at one
    worker / in_flight=1 with the retry and straggler policies on replays
    the sequential driver, and the JAX fleet, bit for bit."""
    def run(S):
        rec = _gemm_recorded(S, "tpu_v5e", "128")
        model = S.tu.train_model(rec, kind="exact")
        store = S.Store()
        store.save_model(rec.space.name, "128", S.key("tpu_v5e"), model,
                         rec.space)
        job = S.fleet.job_from_registry("matmul", "128", S.hw("tpu_v5e"),
                                        budget=40, seed=3, searcher=name)
        rep = S.fleet.FleetTuner([job], S.fleet.VirtualWorkerPool(1),
                                 store=store, in_flight=1,
                                 publish_models=False, retries=2,
                                 straggler_factor=50.0).run()
        s = S.se.make_searcher(name, rec.space, seed=3, model=model,
                               cores=S.cores(S.spec("tpu_v5e")))
        ev = S.ev.ReplayEvaluator(rec)
        S.se.sequential_run_search(s, ev, 40)
        r = rep.results[0]
        assert r.trace == ev.trace and r.history == ev.history()
        assert r.failures == 0 and r.abandoned_s == 0.0
        assert r.known_bad == [] and not r.parked
        return rep

    assert_same_reports(*both(run))


def _one_job(S, budget, seed, hw="tpu_v4"):
    return S.fleet.job_from_registry("matmul", "128", S.hw(hw),
                                     budget=budget, seed=seed,
                                     searcher="random")


def test_failed_test_retries_on_another_lane():
    def run(S):
        pool = _recording_pool(
            S, workers=2,
            fail_fn=lambda item: "boom" if item.uid == 0 else None)
        rep = S.fleet.FleetTuner([_one_job(S, 6, 0)], pool, store=None,
                                 publish_models=False, retries=2).run()
        r = rep.results[0]
        assert r.trials == 6 and all(np.isfinite(rt) for _, rt in r.history)
        assert r.failures == 1 and r.known_bad == []
        assert r.abandoned_s > 0.0 and rep.abandoned == r.abandoned_s
        retry = [it for it in pool.items if it.attempt == 1]
        assert len(retry) == 1 and retry[0].index == pool.items[0].index
        assert retry[0].exclude == (0,) and rep.max_retries_used == 1
        return rep

    assert_same_reports(*both(run))


def test_config_failing_twice_is_marked_known_bad():
    def run(S):
        bad = {}

        def fail_fn(item):
            bad.setdefault("index", item.index)
            return "boom" if item.index == bad["index"] else None

        rep = S.fleet.FleetTuner(
            [_one_job(S, 6, 0)],
            S.fleet.VirtualWorkerPool(workers=2, fail_fn=fail_fn),
            store=None, publish_models=False, retries=2,
            known_bad_after=2).run()
        r = rep.results[0]
        assert r.known_bad == [bad["index"]] and r.failures == 2
        assert rep.max_retries_used == 1 and r.trials == 6
        assert [(i, rt) for i, rt in r.history if not np.isfinite(rt)] == \
            [(bad["index"], float("inf"))]
        assert r.best_index is not None and np.isfinite(r.best_runtime)
        assert rep.known_bad == 1
        return rep

    assert_same_reports(*both(run))


def test_retry_budget_exhaustion_is_not_known_bad():
    def run(S):
        pool = S.fleet.VirtualWorkerPool(
            workers=2, fail_fn=lambda item: "boom" if item.uid == 0 else None)
        rep = S.fleet.FleetTuner([_one_job(S, 4, 0)], pool, store=None,
                                 publish_models=False, retries=0,
                                 known_bad_after=2).run()
        r = rep.results[0]
        assert r.failures == 1 and r.trials == 4
        assert r.known_bad == [] and rep.known_bad == 0
        assert sum(1 for _, rt in r.history if not np.isfinite(rt)) == 1
        return rep

    assert_same_reports(*both(run))


def test_lane_kill_mid_run_recovers():
    def run(S):
        def jobs():
            return [S.fleet.job_from_registry("matmul", "128", S.hw(hw),
                                              budget=12, seed=1,
                                              searcher="random")
                    for hw in ("tpu_v4", "tpu_v5e")]

        base = S.fleet.FleetTuner(jobs(), S.fleet.VirtualWorkerPool(2),
                                  store=None, publish_models=False).run()
        pool = S.fleet.VirtualWorkerPool(
            workers=2, kill_lane_at={1: base.elapsed * 0.3})
        rep = S.fleet.FleetTuner(jobs(), pool, store=None,
                                 publish_models=False, retries=2).run()
        for r in rep.results:
            assert r.trials == 12
            assert all(np.isfinite(rt) for _, rt in r.history)
            assert r.known_bad == []
        assert rep.failures >= 1 and pool.alive_workers() == 1
        return rep

    assert_same_reports(*both(run))


def test_fleet_survives_total_pool_death():
    def run(S):
        pool = S.fleet.VirtualWorkerPool(workers=1, kill_lane_at={0: 0.0})
        rep = S.fleet.FleetTuner([_one_job(S, 4, 0)], pool, store=None,
                                 publish_models=False, retries=1).run()
        r = rep.results[0]
        assert r.best_index is None and r.best_runtime == float("inf")
        assert r.best_config == {} and r.trials == 4
        assert all(not np.isfinite(rt) for _, rt in r.history)
        return rep

    assert_same_reports(*both(run))


def test_straggler_timeout_resubmits_and_charges():
    def run(S):
        slow = {}

        def cost_scale(item):
            slow.setdefault("uid", item.uid)
            return 200.0 if item.uid == slow["uid"] else 1.0

        pool = S.fleet.VirtualWorkerPool(workers=2, cost_scale=cost_scale)
        rep = S.fleet.FleetTuner([_one_job(S, 16, 2)], pool, store=None,
                                 publish_models=False, retries=2,
                                 straggler_factor=3.0).run()
        r = rep.results[0]
        assert rep.timeouts == 1 and r.trials == 16
        assert all(np.isfinite(rt) for _, rt in r.history)
        assert r.abandoned_s > 10 * (r.busy - r.abandoned_s) / 16
        assert r.busy > r.abandoned_s > 0.0
        return rep

    assert_same_reports(*both(run))


def test_record_abandoned_accounts_busy_not_steps():
    acct = pacc.EvalAccount()
    acct.record_completion(1, 1.0, cost=2.0, finished_at=2.0)
    acct.record_abandoned(3.0)
    assert acct.busy == 5.0
    assert acct.abandoned == 3.0 and acct.abandoned_count == 1
    assert acct.steps == 1 and len(acct.trace) == 1 and acct.best_index == 1


# =============================================================================
# Gain-priority dispatch: prefer gain, park inside the band, unpark
# =============================================================================
def _gemm_job(S, name, hw, bucket="128", budget=12, seed=5, searcher=None):
    space, wl = _gemm(S)
    return S.fleet.TuningJob(name=name, space=space, workload_fn=wl,
                             hardware=S.hw(hw), bucket=bucket, budget=budget,
                             seed=seed, searcher=searcher)


def _seed_store(S, store, bucket, hw):
    rec = _gemm_recorded(S, "tpu_v4", "128")
    store.save_model(rec.space.name, bucket, S.key(hw),
                     S.tu.train_model(rec, kind="exact"), rec.space)


def test_priority_prefers_higher_remaining_gain(monkeypatch):
    def fake_pred(model, space, hw):
        return np.full(len(space), 1e-9 if hw.name == "tpu_v4" else 1e6)

    def run(S):
        monkeypatch.setattr(f"{S.tuner_path}.predicted_runtimes", fake_pred)
        store = S.Store()
        _seed_store(S, store, "128", "tpu_v4")
        jobs = [_gemm_job(S, "A", "tpu_v4", budget=10, searcher="random"),
                _gemm_job(S, "B", "tpu_v5e", budget=10, searcher="random")]
        pool = _recording_pool(S, workers=2)
        rep = S.fleet.FleetTuner(jobs, pool, store=store, in_flight=2,
                                 publish_models=False).run()
        by = rep.by_job()
        assert by["A"].trials == 10 and by["B"].trials == 10
        assert by["A"].elapsed < by["B"].elapsed
        assert pool.items[-1].job == "B"
        return rep

    assert_same_reports(*both(run), clock=False)


def test_warm_job_inside_band_is_parked(monkeypatch):
    def run(S):
        monkeypatch.setattr(f"{S.tuner_path}.predicted_runtimes",
                            lambda m, s, hw: np.full(len(s), 1e6))
        store = S.Store()
        _seed_store(S, store, "128", "tpu_v4")
        rep = S.fleet.FleetTuner([_gemm_job(S, "warm", "tpu_v4", budget=20)],
                                 S.fleet.VirtualWorkerPool(workers=2),
                                 store=store, publish_models=False,
                                 park_factor=1.1).run()
        r = rep.results[0]
        assert r.warm_started and r.parked and 0 < r.trials < 20
        assert rep.parked == 1
        return rep

    assert_same_reports(*both(run))


def test_parked_job_unparks_on_better_model_publish(monkeypatch):
    def run(S):
        calls = {"v5e": 0}

        def fake_pred(model, space, hw):
            if hw.name == "tpu_v5e":
                calls["v5e"] += 1
                return np.full(len(space),
                               1e6 if calls["v5e"] == 1 else 1e-9)
            return np.full(len(space), 1e-9)

        monkeypatch.setattr(f"{S.tuner_path}.predicted_runtimes", fake_pred)
        store = S.Store()
        _seed_store(S, store, "b", "tpu_v5e")
        jobs = [_gemm_job(S, "A", "tpu_v4", bucket="a", budget=6,
                          searcher="random"),
                _gemm_job(S, "B", "tpu_v5e", bucket="b", budget=10)]
        rep = S.fleet.FleetTuner(jobs, S.fleet.VirtualWorkerPool(workers=2),
                                 store=store, publish_models=True,
                                 park_factor=1.1).run()
        by = rep.by_job()
        assert by["B"].warm_started and by["B"].parked
        assert by["B"].trials == 10 and calls["v5e"] >= 2
        assert store.get_model_dict("gemm", "a", S.key("tpu_v4")) is not None
        return rep, store

    (jrep, jstore), (prep, pstore) = both(run)
    assert_same_reports(jrep, prep, clock=False)
    assert_same_store(jstore, pstore)


# =============================================================================
# Elastic in_flight
# =============================================================================
def test_elastic_controller_bounds():
    c = pev.ElasticInFlight(lo=2, hi=8)
    assert c.target(4) == 4
    for _ in range(8):
        c.observe(0.01)
    assert c.target(4) == 4
    v = pev.ElasticInFlight(lo=2, hi=8)
    for d in (0.01, 1.0) * 6:
        v.observe(d)
    assert 4 < v.target(4) <= 8
    assert pev.ElasticInFlight(lo=1, hi=1).target(4) == 1
    assert pev.ElasticInFlight(lo=6, hi=9).target(2) == 6
    with pytest.raises(ValueError):
        pev.ElasticInFlight(lo=0, hi=4)
    with pytest.raises(ValueError):
        pev.ElasticInFlight(lo=4, hi=2)
    c.observe(float("inf"))
    c.observe(-1.0)
    assert c.target(4) == 4


def test_run_search_elastic_respects_budget():
    rec = _gemm_recorded(PORT)
    ev = pev.VirtualAsyncEvaluator(pev.ReplayEvaluator(rec), workers=4)
    s = pse.make_searcher("random", rec.space, seed=2)
    pse.run_search(s, ev, 30, in_flight=2, in_flight_max=6)
    assert ev.steps == 30 and ev.outstanding() == 0


def test_run_search_elastic_pinned_matches_sequential():
    rec = _gemm_recorded(PORT)
    s_seq = pse.make_searcher("random", rec.space, seed=7)
    s_el = pse.make_searcher("random", rec.space, seed=7)
    ev_seq, ev_el = pev.ReplayEvaluator(rec), pev.ReplayEvaluator(rec)
    pse.sequential_run_search(s_seq, ev_seq, 25)
    pse.run_search(s_el, ev_el, 25, in_flight=1, in_flight_max=1)
    assert ev_el.trace == ev_seq.trace


def test_run_search_rejects_bad_elastic_bounds():
    rec = _gemm_recorded(PORT)
    s = pse.make_searcher("random", rec.space, seed=0)
    with pytest.raises(ValueError):
        pse.run_search(s, pev.ReplayEvaluator(rec), 10, in_flight=4,
                       in_flight_max=2)


def test_fleet_elastic_in_flight_stays_within_bounds():
    def eval_fn(index, profile):
        return 0.001 * (index + 1), None, (0.5 if index % 2 else 0.001)

    def run(S):
        elastic = _recording_pool(S, workers=2)
        rep = S.fleet.FleetTuner([_eval_fn_job(S, "j", eval_fn, 24, 3)],
                                 elastic, store=None, publish_models=False,
                                 in_flight=2, in_flight_max=6).run()
        assert rep.results[0].trials == 24
        assert 2 < elastic.max_out <= 6 and rep.in_flight_max == 6
        fixed = _recording_pool(S, workers=2)
        S.fleet.FleetTuner([_eval_fn_job(S, "j", eval_fn, 24, 3)], fixed,
                           store=None, publish_models=False,
                           in_flight=2).run()
        assert fixed.max_out <= 2
        with pytest.raises(ValueError):
            S.fleet.FleetTuner([_eval_fn_job(S, "j", eval_fn, 24, 3)],
                               _recording_pool(S, workers=2), in_flight=4,
                               in_flight_max=2)
        return rep, elastic.max_out

    (jrep, jmax), (prep, pmax) = both(run)
    assert_same_reports(jrep, prep)
    assert pmax == jmax


@pytest.mark.parametrize("name", ["profile", "profile_local"])
def test_profile_searcher_survives_failed_profile(name):
    rec = _gemm_recorded(PORT)
    model = ptu.train_model(rec, kind="exact")
    s = pse.make_searcher(name, rec.space, seed=0, model=model,
                          cores=port_spec(jhw.SPECS["tpu_v5e"]).sms)
    first = s.propose(1)
    assert first and first[0].profile
    s.observe([pacc.Observation(index=first[0].index, runtime=float("inf"),
                                counters=None)])
    nxt = s.propose(1)
    assert nxt and nxt[0].profile and nxt[0].index != first[0].index


# =============================================================================
# Store: artifact revisions supersede on merge; prune GC
# =============================================================================
def test_model_retrain_bumps_revision():
    rec = _gemm_recorded(PORT)
    model = ptu.train_model(rec, kind="exact")
    store = PStore()
    store.save_model(rec.space.name, "b", "hw", model, rec.space, n_obs=10)
    assert store.get_model_dict(rec.space.name, "b", "hw")["revision"] == 1
    store.save_model(rec.space.name, "b", "hw", model, rec.space, n_obs=50)
    art = store.get_model_dict(rec.space.name, "b", "hw")
    assert art["revision"] == 2 and art["n_obs"] == 50


def test_model_merge_resolves_by_revision(tmp_path):
    rec = _gemm_recorded(PORT)
    model = ptu.train_model(rec, kind="exact")
    space, path = rec.space, str(tmp_path / "s.json")
    a = PStore(path)
    a.save_model(space.name, "b", "hw", model, space, n_obs=10)
    b = PStore(path)
    b.save_model(space.name, "b", "hw", model, space, n_obs=50)
    a.save()
    art = PStore(path).get_model_dict(space.name, "b", "hw")
    assert art["revision"] == 2 and art["n_obs"] == 50
    assert a.get_model_dict(space.name, "b", "hw")["revision"] == 2


def test_store_prune_gcs_and_stays_pruned(tmp_path):
    path = str(tmp_path / "s.json")
    store = PStore(path)
    for hw in ("hw1", "hw2"):
        store.put("sp", "b", hw, config={"X": 1}, runtime=1.0, trials=1)
        store.put_model_dict("sp", "b", hw, {"kind": "stub"})
    store.put("other", "b", "hw1", config={"X": 1}, runtime=1.0, trials=1)
    preview = store.prune(keep_hardware={"hw1"}, dry_run=True)
    assert (preview["dropped"], preview["dropped_entries"],
            preview["dropped_models"]) == (2, 1, 1)
    assert store.get("sp", "b", "hw2") is not None
    stats = store.prune(keep_hardware={"hw1"})
    assert stats == preview
    assert stats["kept_entries"] == 2 and stats["kept_models"] == 1
    assert store.get("sp", "b", "hw2") is None
    again = PStore(path)
    assert again.get("sp", "b", "hw2") is None
    assert again.get_model_dict("sp", "b", "hw2") is None
    assert store.prune(keep_spaces={"sp"})["dropped"] == 1
    assert store.prune(keep_buckets={"b"})["dropped"] == 0
    assert PStore(path).get("other", "b", "hw1") is None


# =============================================================================
# Subprocess lanes on the CPU
# =============================================================================
def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _ask(module, requests, args=()):
    """Replies of ``python -m module`` to JSON-lines ``requests``."""
    lines = "".join(json.dumps(r) + "\n" for r in requests)
    out = subprocess.run([sys.executable, "-m", module, *args], input=lines,
                         capture_output=True, text=True, timeout=300,
                         env=_worker_env())
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.strip()]


def test_priced_lane_replies_as_the_jax_worker_does():
    """The same requests to the port's worker and the JAX package's, on
    one registered spec each side knows by name (the port's through its
    numbers): the same runtimes, and ops and stress under the counter map."""
    requests = [{"uid": u, "kernel": k, "input": i, "index": x,
                 "profile": bool(u % 2), "attempt": u % 3}
                for u, (k, i, x) in enumerate(
                    [("matmul", "128", 0), ("matmul", "2048", 17),
                     ("conv2d", "4096", 40), ("coulomb", "default", 3),
                     ("nbody", "16k", 9), ("transpose", "8192", 5),
                     ("attention", "default", 11)])]
    spec = dataclasses.asdict(port_spec(jhw.SPECS["tpu_v4"]))
    ours = _ask("repro_torch.fleet.worker_main",
                [{"op": "ping"}] + [dict(r, hw_spec=spec) for r in requests])
    theirs = _ask("repro.fleet.worker_main",
                  [{"op": "ping"}] + [dict(r, hw="tpu_v4") for r in requests])
    assert ours[0]["op"] == "pong" and ours[0]["device"] is None
    for o, t in zip(ours[1:], theirs[1:]):
        assert "error" not in o, o
        assert (o["uid"], o["attempt"]) == (t["uid"], t["attempt"])
        assert o["runtime"] == t["runtime"]
        assert ("ops" in o) == ("ops" in t)
        if "ops" in o:
            for field in ("ops", "stress"):
                assert {PC.TPU_NAMES[k]: v for k, v in o[field].items()} == \
                    t[field]


def test_lanes_never_price_in_place_of_measuring(tmp_path):
    """A priced lane refuses a measured request; a measuring lane (here on
    the CPU) refuses a priced one and measures a measured one."""
    req = {"uid": 1, "kernel": "matmul", "input": "128", "index": 0,
           "hw": "h100_sxm"}
    priced = _ask("repro_torch.fleet.worker_main",
                  [dict(req, measure=True), dict(req, uid=2)])
    assert "priced in its place" in priced[0]["error"]
    assert "error" not in priced[1]
    measuring = _ask("repro_torch.fleet.worker_main",
                     [{"op": "ping"}, dict(req), dict(req, uid=2,
                                                      measure=True,
                                                      profile=True)],
                     args=("--device", "cpu"))
    assert measuring[0]["device_name"] == "cpu"
    assert "lane without a device" in measuring[1]["error"]
    reply = measuring[2]
    assert "error" not in reply, reply
    assert reply["device_name"] == "cpu" and reply["runtime"] > 0
    assert "ops" in reply and reply["launches"]["matmul"] == 0


def test_a_lane_refuses_hardware_other_than_its_card():
    lane = pworker._Lane(None)
    lane.device, lane.device_name, lane.hw = "cpu", "a card", phw.H100_SXM
    with pytest.raises(RuntimeError, match="not 'h100_pcie'"):
        lane.measure({"kernel": "matmul", "input": "128", "index": 0,
                      "hw": "h100_pcie", "measure": True}, {})


def test_subprocess_pool_matches_virtual():
    """Two priced subprocess lanes agree with the virtual pool on what they
    measured (the cost model is pure)."""
    def jobs():
        return [pfleet.job_from_registry("matmul", "128", hw, budget=8,
                                         seed=3, searcher="random")
                for hw in ("h100_sxm", "h100_pcie")]

    pool = pfleet.SubprocessWorkerPool(workers=2)
    try:
        assert [lane["device"] for lane in pool.lane_info()] == [None, None]
        rep_sub = pfleet.FleetTuner(jobs(), pool, store=None,
                                    publish_models=False).run()
    finally:
        pool.close()
    rep_virt = pfleet.FleetTuner(jobs(), pfleet.VirtualWorkerPool(2),
                                 store=None, publish_models=False).run()
    virt = rep_virt.by_job()
    for r in rep_sub.results:
        assert r.trials == virt[r.job].trials
        assert sorted(r.history) == sorted(virt[r.job].history)


def test_subprocess_lane_death_drains_before_fleet_dead():
    """Kill 1 of 2 lanes (then both): completed results are never lost,
    lane death comes back as FailedResult(kind='lane'), an injected
    failure as kind 'test', and an all-dead pool as kind 'pool'."""
    ok = {"kernel": "matmul", "input": "128", "hw": "h100_sxm"}
    WorkItem = pfleet.WorkItem
    pool = pfleet.SubprocessWorkerPool(workers=2)
    try:
        pool.submit(WorkItem(uid=1, job="j", index=0, payload=dict(ok)))
        res1 = pool.collect(timeout=120)
        assert res1.uid == 1 and res1.error is None
        assert np.isfinite(res1.runtime)
        pool.submit(WorkItem(uid=2, job="j", index=1,
                             payload={"sim_crash": True}))
        res2 = pool.collect(timeout=120)
        assert isinstance(res2, pfleet.FailedResult)
        assert res2.uid == 2 and res2.kind == pfleet.FAIL_LANE
        pool.submit(WorkItem(uid=3, job="j", index=2, payload=dict(ok)))
        res3 = pool.collect(timeout=120)
        assert res3.uid == 3 and res3.error is None
        pool.submit(WorkItem(uid=4, job="j", index=3,
                             payload={"sim_fail": True}))
        res4 = pool.collect(timeout=120)
        assert res4.kind == pfleet.FAIL_TEST
        assert "InjectedFailure" in res4.error
        pool.submit(WorkItem(uid=5, job="j", index=4,
                             payload={"sim_crash": True}))
        assert pool.collect(timeout=120).kind == pfleet.FAIL_LANE
        pool.submit(WorkItem(uid=6, job="j", index=5, payload=dict(ok)))
        res6 = pool.collect(timeout=120)
        assert isinstance(res6, pfleet.FailedResult)
        assert res6.kind == pfleet.FAIL_POOL and "died" in res6.error
        assert pool.alive_workers() == 0
    finally:
        pool.close()


@pytest.mark.parametrize("kw", [
    dict(devices=["cpu", "cpu"]),            # two lanes on one card
    dict(workers=2, devices=["cpu"]),        # more lanes than cards
    dict(devices=["cuda:7"]),                # a card that is not visible
    dict(devices=[]),
    dict(devices=["meta"]),
], ids=["one-card-twice", "more-lanes", "invisible", "none", "meta"])
def test_a_measuring_pool_refuses_more_lanes_than_cards(kw):
    with pytest.raises(ValueError):
        pfleet.SubprocessWorkerPool(**kw)


# =============================================================================
# Measured jobs
# =============================================================================
def test_measured_job_on_a_thread_pool_goes_through_the_card_evaluator(
        monkeypatch):
    """A job measured on the CPU (the plain versions) runs every test
    through ``DeviceKernelEvaluator`` — never the cost model — and its
    results carry measured runtimes."""
    built = []
    real = pev.DeviceKernelEvaluator

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(pev, "DeviceKernelEvaluator", Recording)

    def refuse(*a, **k):
        raise AssertionError("a measured job was priced")

    jobs = [dataclasses.replace(
        pfleet.job_from_registry("matmul", "128", "h100_sxm", budget=5,
                                 seed=s, searcher="random", device="cpu"),
        name=f"measured{s}") for s in (0, 1)]
    assert all(j.measured and j.device == "cpu" for j in jobs)
    monkeypatch.setattr("repro_torch.fleet.tuner.costmodel.execute", refuse)
    pool = pfleet.ThreadWorkerPool(workers=2)
    try:
        rep = pfleet.FleetTuner(jobs, pool, store=None,
                                publish_models=False).run()
    finally:
        pool.close()
    assert len(built) == 2 and all(ev.device_name == "cpu" for ev in built)
    for r in rep.results:       # one evaluator a job, built by its thread
        assert r.trials == 5 and r.failures == 0
        assert all(np.isfinite(rt) and rt > 0 for _, rt in r.history)
        assert any({i for i, _ in r.history} <= set(ev.measured)
                   for ev in built)


def test_timed_windows_on_one_device_never_overlap(monkeypatch):
    """Two evaluators on one device, timed from two threads: the per-device
    lock serializes their windows."""
    bench = PB["matmul"]
    evs = [pev.DeviceKernelEvaluator(bench.space(), bench,
                                     bench.inputs["128"], hw=phw.H100_SXM,
                                     device="cpu", reps=2, warmup=0)
           for _ in range(2)]
    windows, real = [], pev.DeviceKernelEvaluator._time_alone

    def timed(self, cfg):
        t0 = time.perf_counter()
        out = real(self, cfg)
        time.sleep(0.01)
        windows.append((t0, time.perf_counter()))
        return out

    monkeypatch.setattr(pev.DeviceKernelEvaluator, "_time_alone", timed)
    threads = [threading.Thread(target=lambda ev=ev: [ev.measure(i)
                                                      for i in range(4)])
               for ev in evs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    windows.sort()
    assert len(windows) == 8
    assert all(a[1] <= b[0] for a, b in zip(windows, windows[1:]))


def test_a_job_naming_a_card_of_another_spec_is_refused(monkeypatch):
    monkeypatch.setattr(phw, "detect", lambda index=0: phw.H100_SXM)
    with pytest.raises(ValueError, match="h100_pcie"):
        pfleet.job_from_registry("matmul", "128", "h100_pcie",
                                 device="cuda:0")
    job = pfleet.job_from_registry("matmul", "128", None, device="cuda:0")
    assert job.hw_spec() is phw.H100_SXM and job.name == \
        "matmul/128@h100_sxm"
    with pytest.raises(ValueError, match="hardware="):
        pfleet.job_from_registry("matmul", "128", None, device="cpu")


def test_a_measured_job_without_an_evaluator_is_never_priced():
    job = pfleet.job_from_registry("matmul", "128", "h100_sxm", budget=2,
                                   device="cpu")
    job.eval_fn = None
    with pytest.raises(ValueError, match="no eval_fn"):
        pfleet.FleetTuner([job], pfleet.VirtualWorkerPool(1), store=None,
                          publish_models=False).run()


# =============================================================================
# The CLI
# =============================================================================
def _cli(args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", *args],
        capture_output=True, text=True, timeout=300, env=_worker_env(),
        cwd=tmp_path)


def test_cli_prices_on_the_virtual_backend_and_writes_its_report(tmp_path):
    out = tmp_path / "fleet.json"
    store = tmp_path / "store.json"
    res = _cli(["--backend", "virtual", "--kernels", "matmul,conv2d",
                "--inputs", "128,4096", "--hw", "h100_sxm,H100-PCIe",
                "--budget", "6", "--store", str(store), "--out", str(out)],
               tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["backend"] == "virtual" and rep["devices"] is None
    assert sorted(j["job"] for j in rep["jobs"]) == [
        "conv2d/4096@h100_pcie", "conv2d/4096@h100_sxm",
        "matmul/128@h100_pcie", "matmul/128@h100_sxm"]
    assert all(j["trials"] == 6 and j["best_runtime_s"] > 0
               for j in rep["jobs"])
    assert len(PStore(str(store))) == 4
    again = _cli(["--backend", "virtual", "--kernels", "matmul",
                  "--inputs", "128", "--budget", "4", "--store", str(store),
                  "--out", str(out)], tmp_path)
    assert again.returncode == 0, again.stderr[-2000:]
    assert json.loads(out.read_text())["jobs"][0]["warm_started"]


@pytest.mark.parametrize("args", [
    ["--system", "qwen2.5-3b", "--backend", "virtual"],
    ["--problem", "sharding:qwen2.5-3b/train_4k", "--backend", "virtual"],
    ["--problem", "serve:p9n9", "--backend", "virtual"],
], ids=["system", "sharding", "serve"])
def test_cli_refuses_the_problem_kinds_not_ported(args, tmp_path):
    # every problem kind is ported now: --system and the sharding and
    # serve kinds tune, priced on the virtual backend
    out = tmp_path / "fleet.json"
    res = _cli(args + ["--budget", "3", "--out", str(out)], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    jobs = json.loads(out.read_text())["jobs"]
    assert jobs and all(j["trials"] == 3 for j in jobs)
    assert {j["job"].partition(":")[0] for j in jobs} >= (
        {"sharding"} if "sharding" in " ".join(args) else {"serve"})


def test_cli_measures_by_default_and_refuses_without_a_card(tmp_path,
                                                            monkeypatch):
    from repro_torch.launch import fleet as cli

    monkeypatch.setattr(cli, "visible_cards", lambda: [])
    with pytest.raises(SystemExit, match="--devices cpu"):
        cli.main(["--kernels", "matmul", "--inputs", "128"])


def test_cli_measures_on_the_cpu_when_asked(tmp_path):
    out = tmp_path / "fleet.json"
    res = _cli(["--devices", "cpu", "--hw", "h100_sxm", "--kernels",
                "matmul", "--inputs", "128", "--budget", "3", "--out",
                str(out)], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["backend"] == "subprocess" and rep["devices"] == ["cpu"]
    assert rep["lanes"][0]["device_name"] == "cpu"
    assert rep["jobs"][0]["trials"] == 3
