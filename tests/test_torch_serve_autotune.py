"""The port's online serving autotuner (``repro_torch.serve.autotune``)
against the JAX package's (``repro.serve.autotune``), and every case of
``tests/test_serve_autotune.py`` run through the port.

Parity, under the maps of the earlier slices: the JAX package's TPU specs
converted field by field and registered in the port under their own names
(the ``tpu_names`` fixture, so both stores key by ``tpu_v4``), counters
under ``counters.TPU_NAMES``, model artifacts through
``from_jax_artifact``.  ``ServeProblem``'s workload model and priced
evaluator equal the JAX ones to 1e-12 (relative); ``OnlineAutotuner`` on
``SyntheticServeBackend`` gives the same ticks, live trials, stored
configs and models, and the golden ask-tell trace.  ``EngineBackend`` runs
the port's engine on the CPU.
"""
import dataclasses
import json

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch

import repro.serve.autotune as J
import repro.tuning.problem as JP
import repro_torch.serve.autotune as A
import repro_torch.tuning.problem as PP
from _torch_service_sides import tpu_names  # noqa: F401  (fixture)
from repro.core import hwspec as jhw
from repro.serve.engine import Request as JRequest
from repro.tuning import ConfigStore as JStore
from repro_torch.core import counters as PC
from repro_torch.core import evaluate as pev
from repro_torch.core import hwspec as phw
from repro_torch.serve import engine as E
from repro_torch.serve.autotune import (INFEASIBLE_S, EngineBackend,
                                        OnlineAutotuner, ServeWorkloadStats,
                                        ShapeBucketer, SyntheticServeBackend,
                                        serve_space, serve_workload_fn)
from repro_torch.serve.engine import Request
from repro_torch.tuning import ConfigStore, TuningSession, from_jax_artifact
from repro_torch.tuning.store import StoreEntry, store_key
from test_torch_serve import EchoModel
from test_torch_space_costmodel import port_spec

HW_TRUE = port_spec(jhw.SPECS["tpu_v4"])
HW_TRAIN = port_spec(jhw.SPECS["tpu_v5e"])
STATS = ServeWorkloadStats()
TOL = 1e-12


def reqs(plen, new, n=8, uid0=0, cls=Request):
    return [cls(uid=uid0 + i, prompt=np.ones(plen, np.int32),
                max_new_tokens=new) for i in range(n)]


def make_tuner(store=None, seed=0, **kw):
    backend = SyntheticServeBackend(HW_TRUE, STATS, seed=seed)
    tuner = OnlineAutotuner(
        backend, store=store, bucketer=ShapeBucketer(max_prompt=96,
                                                     max_new=32),
        hw=HW_TRUE, train_hw=HW_TRAIN, stats=STATS, seed=seed, **kw)
    return tuner, backend


def make_jax_tuner(store=None, seed=0, **kw):
    backend = J.SyntheticServeBackend(jhw.SPECS["tpu_v4"], J.ServeWorkloadStats(),
                                      seed=seed)
    tuner = J.OnlineAutotuner(
        backend, store=store, bucketer=J.ShapeBucketer(max_prompt=96,
                                                       max_new=32),
        hw=jhw.SPECS["tpu_v4"], train_hw=jhw.SPECS["tpu_v5e"],
        stats=J.ServeWorkloadStats(), seed=seed, **kw)
    return tuner, backend


def _close(a, b) -> bool:
    return abs(a - b) <= TOL * max(abs(a), abs(b), 1e-300)


# =============================================================================
# Parity with the JAX package
# =============================================================================
@pytest.mark.parametrize("bucket,params", [
    ("p9n9", {}), ("p1n1", {}), ("p4n0", {"arch": "qwen2.5-3b"}),
    ("p2n2", {"shape": (40, 12), "batch_sizes": (1, 2, 4, 8, 16),
              "max_seqs": (32, 64, 96, 128)}),
    ("p7n3", {"stats": {"param_bytes": 1e6, "d_model": 32, "n_layers": 2},
              "calib_n": 4}),
])
def test_serve_problem_equals_the_jax_one(bucket, params):
    """The registry's ``serve`` kind builds the same problem: space,
    workload model (counters under TPU_NAMES) and the priced evaluator's
    runtime, counters and cost at every configuration, to 1e-12."""
    p = PP.make_problem("serve", bucket, **params)
    j = JP.make_problem("serve", bucket, **params)
    assert (p.kind, p.name, p.bucket, p.spec, p.rep_shape) \
        == (j.kind, j.name, j.bucket, j.spec, j.rep_shape)
    assert p.describe() == j.describe()
    pwl, jwl = p.workload_fn(), j.workload_fn()
    for cfg in p.space():
        ours = {PC.TPU_NAMES[k]: v for k, v in pwl(cfg).items()}
        theirs = jwl(cfg)
        assert set(ours) == set(theirs)
        assert all(_close(ours[k], theirs[k]) for k in theirs), cfg
    for hw in ("tpu_v4", "tpu_v5e"):
        pev_, jev_ = p.make_evaluator(port_spec(jhw.SPECS[hw])), \
            j.make_evaluator(jhw.SPECS[hw])
        for i in range(len(p.space())):
            for profile in (False, True):
                prt, pcs, pcost = pev_(i, profile)
                jrt, jcs, jcost = jev_(i, profile)
                assert _close(prt, jrt) and _close(pcost, jcost)
                if profile:
                    assert _close(pcs.runtime, jcs.runtime)
                    for k, v in pcs.ops.items():
                        assert _close(v, jcs.ops[PC.TPU_NAMES[k]])
                    for k, v in pcs.stress.items():
                        assert _close(v, jcs.stress[PC.TPU_NAMES[k]])


def test_serve_kind_is_registered_and_sharding_is_not():
    # the sharding kind is registered now too, as in the JAX package
    # (tests/test_torch_sharding_problem.py holds it to the JAX one)
    assert PP.problem_kinds() == JP.problem_kinds() == \
        ["kernel", "serve", "sharding"]
    assert PP.list_problems("serve") == JP.list_problems("serve")
    assert PP.make_problem("sharding", "qwen2.5-3b/train_4k").kind \
        == "sharding"
    with pytest.raises(ValueError, match="bucket key"):
        PP.make_problem("serve", "p10n1")


def test_stats_from_arch_equals_the_jax_ones():
    for arch in ("qwen2.5-3b", "deepseek-v2-236b", "xlstm-125m"):
        assert dataclasses.asdict(A.stats_from_arch(arch)) \
            == dataclasses.asdict(J.stats_from_arch(arch))
    with pytest.raises(KeyError):
        A.stats_from_arch("no-such-arch")


def _jax_store_as_port(jstore):
    d = jstore.to_dict()
    return d["entries"], {k: from_jax_artifact(a)
                          for k, a in d["models"].items()}


def _port_store(pstore):
    d = pstore.to_dict()
    return d["entries"], {k: {f: v for f, v in a.items() if f != "signature"}
                          for k, a in d["models"].items()}


def _tick(rep):
    return (rep.bucket, rep.drift, rep.reused, rep.live_trials, rep.config,
            [tuple(h) for h in rep.history], rep.via_service)


def test_online_autotuner_gives_the_jax_ticks_trials_and_store(tpu_names):
    """Drift, retune, return to a stored bucket, an oversize top-decile
    mix: the same reports, live trials, measured calls and stores."""
    mixes = [(12, 6), (12, 6), (80, 28), (12, 6), (150, 30), (40, 20)]
    out = []
    for make, cls in ((make_jax_tuner, JRequest), (make_tuner, Request)):
        store = JStore() if cls is JRequest else ConfigStore()
        tuner, backend = make(store=store, window=8, max_live_trials=5)
        ticks = [_tick(tuner.serve(reqs(p, n, uid0=100 * i, cls=cls))[1])
                 for i, (p, n) in enumerate(mixes)]
        out.append((ticks, backend.measure_calls, backend.serve_calls,
                    backend.virtual_time, store))
    (jt, jm, js, jv, jstore), (pt, pm, ps, pv, pstore) = out
    assert pt == jt and (pm, ps) == (jm, js) and _close(pv, jv)
    assert _port_store(pstore) == _jax_store_as_port(jstore)


# =============================================================================
# Shape buckets
# =============================================================================
def test_bucketer_deciles():
    b = ShapeBucketer(max_prompt=100, max_new=50)
    assert b.bucket_of(0, 0).key == "p0n0"
    assert b.bucket_of(19, 9).key == "p1n1"
    assert b.bucket_of(99, 49).key == "p9n9"
    assert b.bucket_of(500, 500).key == "p9n9"   # clamped to the top decile


def test_bucket_rep_shape_is_upper_edge():
    b = ShapeBucketer(max_prompt=100, max_new=50)
    bucket = b.bucket_of(12, 6)
    assert bucket.key == "p1n1"
    assert b.rep_shape(bucket) == (20, 10)


def test_serve_workload_fn_amortizes_weight_reads():
    wl = serve_workload_fn(16, 12, 6, STATS)
    rd1 = wl({"BATCH": 1, "MAX_SEQ": 32})[PC.DRAM_RD]
    rd8 = wl({"BATCH": 8, "MAX_SEQ": 32})[PC.DRAM_RD]
    assert rd8 < rd1 / 4  # fewer waves -> fewer weight streams


# =============================================================================
# ConfigStore
# =============================================================================
def test_store_key_rejects_separator():
    with pytest.raises(ValueError):
        store_key("a|b", "c", "d")


def test_config_store_round_trip(tmp_path):
    path = str(tmp_path / "store.json")
    store = ConfigStore(path)
    entry = store.put("serve_online", "p1n1", "tpu_v4",
                      config={"BATCH": 8, "MAX_SEQ": 32},
                      runtime=0.012, trials=6, meta={"history": [[15, 0.012]]},
                      kind="serve")
    assert isinstance(entry, StoreEntry)
    again = ConfigStore(path)
    got = again.get("serve_online", "p1n1", "tpu_v4", kind="serve")
    assert got is not None
    assert got.config == {"BATCH": 8, "MAX_SEQ": 32}
    assert got.trials == 6
    assert got.meta["history"] == [[15, 0.012]]
    assert again.get("serve_online", "p9n9", "tpu_v4", kind="serve") is None
    with open(path) as f:
        d = json.load(f)
    assert d["format"] == "repro_torch.config_store" and d["version"] == 3
    assert set(d["entries"]) == {"serve|serve_online|p1n1|tpu_v4"}


def test_config_store_in_memory_has_no_file(tmp_path):
    store = ConfigStore()
    store.put("s", "b", "h", config={"X": 1}, runtime=1.0, trials=1)
    assert len(store) == 1
    with pytest.raises(ValueError):
        store.save()


def test_session_model_store_round_trip(tmp_path):
    space = serve_space()
    wl = serve_workload_fn(16, 20, 7, STATS)
    session = TuningSession(space, wl, hw=HW_TRUE, seed=0)
    session.train(train_hw=HW_TRAIN, kind="tree", sample="full")
    store = ConfigStore(str(tmp_path / "store.json"))
    session.save_model_to_store(store, "p1n1")
    fresh = TuningSession(space, wl, hw=HW_TRUE, seed=0)
    model = fresh.load_model_from_store(store, "p1n1")
    assert model is not None
    ref = session.model.predict(space[3])
    got = model.predict(space[3])
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k])
    assert fresh.load_model_from_store(store, "p9n9") is None


# =============================================================================
# Online tuner: drift, retune, reuse
# =============================================================================
def test_first_tick_tunes_then_steady_state_is_free():
    tuner, backend = make_tuner()
    _, rep = tuner.serve(reqs(12, 6))
    assert rep.drift and not rep.reused
    assert 0 < rep.live_trials <= tuner.max_live_trials
    _, rep2 = tuner.serve(reqs(12, 6, uid0=100))
    assert not rep2.drift and rep2.live_trials == 0
    assert backend.measure_calls == rep.live_trials


def test_drift_triggers_retune_and_return_is_reuse():
    tuner, backend = make_tuner(window=8)
    _, r0 = tuner.serve(reqs(12, 6))
    _, r1 = tuner.serve(reqs(80, 28, uid0=100))
    assert r1.drift and not r1.reused and r1.live_trials > 0
    assert r1.config["MAX_SEQ"] >= 80 + 28
    _, r2 = tuner.serve(reqs(12, 6, uid0=200))
    assert r2.drift and r2.reused and r2.live_trials == 0
    assert r2.config == r0.config


def test_store_persists_across_tuner_restarts(tmp_path, tpu_names):
    path = str(tmp_path / "store.json")
    tuner1, _ = make_tuner(store=ConfigStore(path))
    _, rep1 = tuner1.serve(reqs(12, 6))
    assert rep1.live_trials > 0
    tuner2, backend2 = make_tuner(store=ConfigStore(path))
    _, rep2 = tuner2.serve(reqs(12, 6))
    assert rep2.drift and rep2.reused and rep2.live_trials == 0
    assert rep2.config == rep1.config
    assert backend2.measure_calls == 0


def test_model_artifact_is_persisted(tmp_path, tpu_names):
    path = str(tmp_path / "store.json")
    store = ConfigStore(path)
    tuner, _ = make_tuner(store=store)
    tuner.serve(reqs(12, 6))
    assert store.get_model_dict("serve_online", "p1n1", "tpu_v4",
                                kind="serve") is not None


def test_ranking_excludes_infeasible_max_seq():
    tuner, _ = make_tuner()
    bucket = tuner.bucketer.bucket_of(80, 28)
    plen, new = tuner.bucketer.rep_shape(bucket)
    for i in tuner.ranking(bucket):
        assert tuner.space[i]["MAX_SEQ"] >= plen + new


def test_live_trials_never_exceed_budget():
    tuner, _ = make_tuner(max_live_trials=3)
    _, rep = tuner.serve(reqs(12, 6))
    assert rep.live_trials <= 3


def test_oversize_top_decile_requests_tune_feasibly(tpu_names):
    backend = SyntheticServeBackend(HW_TRUE, STATS, seed=0)
    tuner = OnlineAutotuner(
        backend, bucketer=ShapeBucketer(max_prompt=16, max_new=8),
        space=serve_space(batch_sizes=(1, 2, 4), max_seqs=(16, 32, 64)),
        hw=HW_TRUE, train_hw=HW_TRAIN, stats=STATS, seed=0)
    _, rep = tuner.serve(reqs(40, 8))    # plen 40 >> max_prompt 16
    assert rep.config["MAX_SEQ"] >= 48   # fits the real calibration wave
    entry = tuner.store.get(tuner.space.name, rep.bucket, "tpu_v4",
                            kind="serve")
    assert entry.runtime < INFEASIBLE_S  # never persisted a garbage trial


def test_the_default_hardware_is_the_h100_sxm():
    tuner = OnlineAutotuner(SyntheticServeBackend(phw.H100_SXM, STATS))
    assert tuner.hw is phw.H100_SXM and tuner.hardware_name == "h100_sxm"


# =============================================================================
# Golden ask-tell trace (fixed seed, deterministic fake engine)
# =============================================================================
# the JAX package's golden trace: index = 5*batch_idx + seq_idx over BATCH
# (1,2,4,8,16) x MAX_SEQ (32,64,96,128,192)
GOLDEN_P1N1_TRIAL_ORDER = [15, 16, 10, 11, 12, 13, 14, 17]
GOLDEN_P1N1_CONFIG = {"BATCH": 8, "MAX_SEQ": 32}


def test_golden_ask_tell_trace():
    from test_serve_autotune import GOLDEN_P1N1_CONFIG as JCONFIG
    from test_serve_autotune import GOLDEN_P1N1_TRIAL_ORDER as JORDER

    assert (GOLDEN_P1N1_TRIAL_ORDER, GOLDEN_P1N1_CONFIG) == (JORDER, JCONFIG)
    tuner, _ = make_tuner()
    _, rep = tuner.serve(reqs(12, 6))
    assert rep.bucket == "p1n1"
    assert [i for i, _ in rep.history] == GOLDEN_P1N1_TRIAL_ORDER
    assert rep.config == GOLDEN_P1N1_CONFIG
    runtimes = dict(rep.history)
    best_idx = tuner.space.index_of(rep.config)
    assert min(runtimes.values()) == pytest.approx(runtimes[best_idx])
    jtuner, _ = make_jax_tuner()
    _, jrep = jtuner.serve(reqs(12, 6, cls=JRequest))
    assert [list(h) for h in rep.history] == [list(h) for h in jrep.history]


def test_golden_trace_is_reproducible():
    t1, _ = make_tuner()
    t2, _ = make_tuner()
    _, r1 = t1.serve(reqs(12, 6))
    _, r2 = t2.serve(reqs(12, 6))
    assert r1.history == r2.history
    assert r1.config == r2.config


# =============================================================================
# Backends
# =============================================================================
def test_synthetic_backend_is_deterministic_and_feasibility_aware():
    b1 = SyntheticServeBackend(HW_TRUE, STATS, seed=3)
    b2 = SyntheticServeBackend(HW_TRUE, STATS, seed=3)
    cfg = {"BATCH": 4, "MAX_SEQ": 64}
    r = reqs(12, 6)
    assert b1.measure(cfg, r) == b2.measure(cfg, r)
    assert b1.measure({"BATCH": 4, "MAX_SEQ": 32}, reqs(40, 12)) \
        == INFEASIBLE_S
    jb = J.SyntheticServeBackend(jhw.SPECS["tpu_v4"], J.ServeWorkloadStats(),
                                 seed=3)
    assert _close(b1.measure(cfg, r), jb.measure(cfg, reqs(12, 6,
                                                          cls=JRequest)))


def test_engine_backend_shares_params_and_warms_tail_waves():
    backend = EngineBackend(EchoModel(), seq_round=16, device="cpu")
    backend.measure({"BATCH": 2, "MAX_SEQ": 16}, reqs(3, 2, n=3))
    backend.measure({"BATCH": 2, "MAX_SEQ": 32}, reqs(3, 2, n=3))
    assert backend._warmed[(2, 16)] == {1, 2}
    assert all(e.params is backend.params for e in backend.engines.values())


def test_engine_backend_measures_and_serves_real_engine():
    backend = EngineBackend(EchoModel(), seq_round=16, device="cpu")
    cfg = {"BATCH": 2, "MAX_SEQ": 16}
    r = reqs(3, 2, n=3)
    dt = backend.measure(cfg, r)
    assert dt > 0.0
    assert backend.measure({"BATCH": 2, "MAX_SEQ": 4}, r) == INFEASIBLE_S
    out = backend.serve(cfg, r)
    assert set(out) == {0, 1, 2}
    assert all(len(v) == 2 for v in out.values())
    out2 = backend.serve({"BATCH": 2, "MAX_SEQ": 4}, r)
    assert set(out2) == {0, 1, 2}


def test_engine_backend_times_a_wave_with_the_queue_drained_under_the_lock(
        monkeypatch):
    """The clock starts after the device's queue is drained and is read
    after it is drained again, with the device's timing lock held (so no
    kernel evaluator of this process times in between); the warm-up waves
    run before, untimed and unlocked."""
    events = []
    lock = pev.device_lock(torch.device("cpu"))
    monkeypatch.setattr(E, "synchronize",
                        lambda dev: events.append(("sync", lock.locked())))
    backend = EngineBackend(EchoModel(), device="cpu")
    eng = backend._engine(2, 16)
    gen = eng.generate
    monkeypatch.setattr(type(eng), "generate", lambda self, rs: (
        events.append(("generate", lock.locked(), len(rs))), gen(rs))[1],
        raising=False)
    backend.measure({"BATCH": 2, "MAX_SEQ": 16}, reqs(3, 2, n=2))
    assert events[-3:] == [("sync", True), ("generate", True, 2),
                           ("sync", True)]
    assert ("generate", False, 2) in events[:-3]      # the warm-up


def test_online_tuner_with_real_engine_backend(tmp_path, tpu_names):
    stats = ServeWorkloadStats(param_bytes=1e6, d_model=32, n_layers=2)
    backend = EngineBackend(EchoModel(), seq_round=16, device="cpu")
    store = ConfigStore(str(tmp_path / "store.json"))
    tuner = OnlineAutotuner(
        backend, store=store, bucketer=ShapeBucketer(max_prompt=8, max_new=4),
        space=serve_space(batch_sizes=(1, 2), max_seqs=(16, 32)),
        hw=port_spec(jhw.SPECS["tpu_v5e"]), stats=stats, max_live_trials=3,
        seed=0)
    out, rep = tuner.serve(reqs(4, 2, n=4))
    assert rep.drift and 0 < rep.live_trials <= 3
    assert all(len(v) == 2 for v in out.values())
    assert store.get(tuner.space.name, rep.bucket, "tpu_v5e",
                     kind="serve") is not None


def test_empty_tick_is_a_noop():
    tuner, _ = make_tuner()
    out, rep = tuner.serve([])
    assert out == {} and rep is None
