"""The port's ``sharding`` problem kind (``repro_torch.distributed.tuning``)
and ``system_problems`` against the JAX package's, and the cases of
``tests/test_problems.py`` that cover them, run through both packages.

Parity, under the maps of the earlier slices: counters under
``counters.TPU_NAMES``; the JAX package's TPU specs converted field by
field (``port_spec``) and, where a store or a daemon keys by name,
registered in the port under their own names (the ``tpu_names`` fixture).
The space is equal configuration for configuration, in order; the
workload model, the priced measurement and the evaluator's runtimes,
costs and counters equal the JAX ones to 1e-12 (relative); a sharding
job's fleet trace and store entry on ``VirtualWorkerPool``, and a daemon's
answer to a sharding submit, are the JAX ones.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest

import repro.distributed.tuning as JT
import repro.tuning.problem as JP
import repro_torch.distributed.tuning as PT
import repro_torch.tuning.problem as PP
from _torch_service_sides import JAX as JSIDE
from _torch_service_sides import PORT as PSIDE
from _torch_service_sides import (both, drive, final_state, make_daemon,
                                  tpu_names)  # noqa: F401  (fixture)
from repro.core import hwspec as jhw
from repro.fleet import FleetTuner as JFleet
from repro.fleet import VirtualWorkerPool as JPool
from repro.fleet import job_from_problem as jjob
from repro.tuning import ConfigStore as JStore
from repro_torch.core import counters as PC
from repro_torch.fleet import FleetTuner as PFleet
from repro_torch.fleet import VirtualWorkerPool as PPool
from repro_torch.fleet import job_from_problem as pjob
from repro_torch.tuning import ConfigStore as PStore
from test_torch_space_costmodel import port_spec

TOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "deepseek-v2-236b"]   # dense, and one MoE arch


def _close(a, b) -> bool:
    return abs(a - b) <= TOL * max(abs(a), abs(b), 1e-300)


def _to_tpu(d):
    return {PC.TPU_NAMES[k]: v for k, v in d.items()}


def _same_counters(ours, theirs):
    ours = _to_tpu(ours)
    assert set(ours) == set(theirs)
    assert all(_close(ours[k], theirs[k]) for k in theirs), (ours, theirs)


# =============================================================================
# The space and the closed-form arithmetic
# =============================================================================
@pytest.mark.parametrize("n", [1, 8, 64, 256])
def test_sharding_space_equals_the_jax_one(n):
    p, j = PT.sharding_space(n, "s"), JT.sharding_space(n, "s")
    assert p.name == j.name and len(p) == len(j)
    assert [dict(c) for c in p] == [dict(c) for c in j]
    assert [(q.name, q.values) for q in p.parameters] == \
        [(q.name, q.values) for q in j.parameters]
    assert PT.mesh_factorizations(n) == JT.mesh_factorizations(n)
    if n == 64:
        assert len(p) == 72
    for mesh in PT.mesh_factorizations(n):
        assert PT.parse_mesh(mesh) == JT.parse_mesh(mesh)


@pytest.mark.parametrize("n", [0, 6, 48])
def test_mesh_factorizations_refuse_what_jax_refuses(n):
    with pytest.raises(ValueError):
        JT.mesh_factorizations(n)
    with pytest.raises(ValueError):
        PT.mesh_factorizations(n)


def test_the_reference_constants_are_the_jax_ones():
    for name in ("STATE_BYTES_PER_PARAM", "REF_HBM_BYTES", "LANE_GRAN",
                 "TILE_TOKENS", "BYTES"):
        assert getattr(PT, name) == getattr(JT, name), name


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_fn_equals_the_jax_one(arch):
    """Every configuration of ``sharding_space(64)``, counters under
    ``TPU_NAMES``, to 1e-12."""
    p = PP.make_problem("sharding", f"{arch}/train_4k")
    j = JP.make_problem("sharding", f"{arch}/train_4k")
    pwl, jwl = p.workload_fn(), j.workload_fn()
    assert len(p.space()) == 72
    for cfg in p.space():
        _same_counters(pwl(cfg), jwl(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_measure_and_evaluator_equal_the_jax_ones(arch):
    """The priced measurement (skewed counters, seeded jitter) and the
    evaluator's runtime, counters and cost at every configuration, both
    profile modes, on two converted TPU specs."""
    p = PT.ShardingProblem.from_name(f"{arch}/train_4k", seed=5)
    j = JT.ShardingProblem.from_name(f"{arch}/train_4k", seed=5)
    for hw in ("tpu_v4", "tpu_v5e"):
        phw_, jhw_ = port_spec(jhw.SPECS[hw]), jhw.SPECS[hw]
        pev, jev = p.make_evaluator(phw_), j.make_evaluator(jhw_)
        for i, cfg in enumerate(p.space()):
            pcs, jcs = p._measure(cfg, phw_), j._measure(cfg, jhw_)
            assert _close(pcs.runtime, jcs.runtime)
            assert _close(p.measured_runtime(cfg, phw_),
                          j.measured_runtime(cfg, jhw_))
            for profile in (False, True):
                prt, pc, pcost = pev(i, profile)
                jrt, jc, jcost = jev(i, profile)
                assert _close(prt, jrt) and _close(pcost, jcost)
                assert (pc is None) == (jc is None) == (not profile)
                if profile:
                    _same_counters(pc.ops, jc.ops)
                    for k, v in pc.stress.items():
                        assert _close(v, jc.stress[PC.TPU_NAMES[k]])


def test_problem_identity_and_errors_equal_the_jax_ones():
    for name in ("qwen2.5-3b/train_4k", "gemma-2b/prefill_32k",
                 "xlstm-125m"):
        p = PT.ShardingProblem.from_name(name, n_devices=16)
        j = JT.ShardingProblem.from_name(name, n_devices=16)
        assert (p.kind, p.name, p.bucket, p.spec) == \
            (j.kind, j.name, j.bucket, j.spec)
        assert p.describe() == j.describe()
    for bad in ("no-such-arch/train_4k", "qwen2.5-3b/no_such_shape"):
        with pytest.raises(KeyError):
            JT.ShardingProblem.from_name(bad)
        with pytest.raises(KeyError):
            PT.ShardingProblem.from_name(bad)
    with pytest.raises(ValueError, match="backend"):
        PT.ShardingProblem("qwen2.5-3b", backend="wat")


def test_the_compiled_backend_is_refused_naming_the_dry_run():
    """The compiled backend is no longer refused: the port builds it as
    the JAX package does, an evaluator over the dry run (its parity:
    ``tests/test_torch_step_tuner.py``), and an unknown backend is refused
    naming both."""
    j = JT.ShardingProblem("qwen2.5-3b", backend="compiled")
    p = PT.ShardingProblem("qwen2.5-3b", backend="compiled")
    assert p.backend == j.backend == "compiled"
    assert (p.name, p.bucket, p.spec) == (j.name, j.bucket, j.spec)
    assert callable(p.make_evaluator(jhw_port("tpu_v5e")))
    with pytest.raises(ValueError, match="'analytic' or 'compiled'"):
        PT.ShardingProblem("qwen2.5-3b", backend="lowered")


def jhw_port(name):
    return port_spec(jhw.SPECS[name])


def test_arch_param_counts_equal_the_jax_ones():
    from repro.configs import ARCHS as JA
    from repro_torch.configs import ARCHS as PA

    for name in PA:
        assert PT.arch_param_count(PA[name]) == JT.arch_param_count(JA[name])
        assert PT.arch_active_param_count(PA[name]) == \
            JT.arch_active_param_count(JA[name])


# =============================================================================
# The registry and system_problems
# =============================================================================
def test_every_problem_kind_of_the_jax_package_is_registered():
    assert PP.problem_kinds() == JP.problem_kinds() == \
        ["kernel", "serve", "sharding"]
    for kind in PP.problem_kinds():
        assert PP.list_problems(kind) == JP.list_problems(kind)
    p = PP.parse_problem("sharding:qwen2.5-3b/train_4k", n_devices=32)
    j = JP.parse_problem("sharding:qwen2.5-3b/train_4k", n_devices=32)
    assert (p.spec, p.bucket, len(p.space())) == \
        (j.spec, j.bucket, len(j.space()))


@pytest.mark.parametrize("kernels", [None, ["matmul"]])
def test_system_problems_equal_the_jax_ones(kernels):
    """Kinds, names, buckets and spaces in order; as jobs, their kinds and
    measurement closures (the kernel jobs replay the cost model, the
    others price in process), each closure's numbers the JAX one's."""
    ps = PP.system_problems("qwen2.5-3b", kernels=kernels)
    js = JP.system_problems("qwen2.5-3b", kernels=kernels)
    assert [(p.kind, p.name, p.bucket) for p in ps] == \
        [(j.kind, j.name, j.bucket) for j in js]
    assert [p.kind for p in ps][-2:] == ["sharding", "serve"]
    assert [p.describe() for p in ps] == [j.describe() for j in js]
    hw = port_spec(jhw.SPECS["tpu_v4"])
    pjobs = [pjob(p, hw, budget=4, seed=0) for p in ps]
    jjobs = [jjob(j, "tpu_v4", budget=4, seed=0) for j in js]
    assert [pj.kind for pj in pjobs] == [jj.kind for jj in jjobs]
    for pj, jj in zip(pjobs, jjobs):
        assert (pj.eval_fn is None) == (jj.eval_fn is None) \
            == (pj.kind == "kernel")
        if pj.eval_fn is not None:
            for i in (0, 3, len(pj.space) - 1):
                prt, _, pcost = pj.eval_fn(i, False)
                jrt, _, jcost = jj.eval_fn(i, False)
                assert _close(prt, jrt) and _close(pcost, jcost)
    with pytest.raises(KeyError):
        PP.system_problems("no-such-arch")


# =============================================================================
# The fleet and the service
# =============================================================================
@pytest.mark.parametrize("budget,workers", [(10, 2), (16, 1)])
def test_a_sharding_job_tunes_through_both_fleets_alike(tpu_names, tmp_path,
                                                        budget, workers):
    """``tests/test_problems.py``'s fleet case through both fleets: the
    same trace, history, best and store entry."""
    results = []
    for name, Store, Pool, Fleet, mk, problem in (
            ("jax", JStore, JPool, JFleet, jjob, JT.ShardingProblem),
            ("port", PStore, PPool, PFleet, pjob, PT.ShardingProblem)):
        p = problem.from_name("qwen2.5-3b/train_4k", seed=0)
        job = mk(p, "tpu_v5e", budget=budget, seed=0)
        assert job.kind == "sharding"
        store = Store(str(tmp_path / f"{name}.json"))
        pool = Pool(workers=workers)
        try:
            rep = Fleet([job], pool, store=store).run()
        finally:
            pool.close()
        r = rep.results[0]
        assert r.trials == budget and r.best_runtime > 0.0
        entry = store.get(job.space.name, job.bucket, job.hardware_key,
                          kind="sharding")
        assert entry is not None and entry.config == r.best_config
        results.append((r, entry.to_dict()))
    (jr, je), (pr, pe) = results
    assert (pr.job, pr.trace, pr.history, pr.best_index, pr.best_config,
            pr.best_runtime, pr.elapsed, pr.searcher) == \
        (jr.job, jr.trace, jr.history, jr.best_index, jr.best_config,
         jr.best_runtime, jr.elapsed, jr.searcher)
    assert pe == je


def _sharding_submit(S, root, spec, budget):
    d = make_daemon(S)
    r = d.handle(S.P.validate_request({
        "op": "submit", "kind": "problem", "tenant": "t", "problem": spec,
        "hardware": "tpu_v4", "budget": budget}))
    assert r["ok"], r
    rid = r["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    res = d.handle({"op": "result", "request_id": rid})
    repeat = d.handle(S.P.validate_request({
        "op": "submit", "kind": "problem", "tenant": "t2", "problem": spec,
        "hardware": "tpu_v4"}))
    assert repeat["state"] == "done" and repeat["trials"] == 0
    return {"submit": r, "result": res, "repeat": repeat,
            "final": final_state(S, d)}


@pytest.mark.parametrize("spec,budget", [
    ("sharding:qwen2.5-3b/train_4k", 5),
    ("sharding:deepseek-v2-236b/train_4k", 8)])
def test_a_daemon_answers_a_sharding_submit_as_the_jax_daemon(
        tpu_names, tmp_path, spec, budget):
    jax_side, port_side = both(_sharding_submit, tmp_path, spec, budget)
    assert port_side["result"]["trials"] == budget
    assert port_side == jax_side


def test_a_daemon_refuses_an_unknown_sharding_problem(tpu_names):
    d = make_daemon(PSIDE)
    r = d.handle(PSIDE.P.validate_request({
        "op": "submit", "kind": "problem", "tenant": "t",
        "problem": "sharding:no-such-arch/train_4k", "hardware": "tpu_v4"}))
    assert not r["ok"] and r["code"] == PSIDE.P.E_UNKNOWN_PROBLEM
    assert d._records == {}
    assert JSIDE.name == "jax"


def _cli(args, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)


def test_the_fleet_cli_tunes_a_whole_system(tmp_path):
    out, store = tmp_path / "fleet.json", tmp_path / "store.json"
    res = _cli(["--system", "qwen2.5-3b", "--backend", "virtual",
                "--budget", "5", "--store", str(store), "--out", str(out)],
               tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    rep = json.loads(out.read_text())
    names = sorted(j["job"] for j in rep["jobs"])
    expect = sorted(f"{p.spec}@h100_sxm"
                    for p in PP.system_problems("qwen2.5-3b"))
    assert names == expect
    assert all(j["trials"] == 5 and 0 < j["best_runtime_s"] < float("inf")
               and j["elapsed_s"] > 0 for j in rep["jobs"])
    assert len(PStore(str(store))) == len(expect)
    assert "sharding:qwen2.5-3b/train_4k@h100_sxm" in res.stdout


@pytest.mark.parametrize("spec", ["sharding:qwen2.5-3b/train_4k",
                                  "serve:p9n9"])
def test_the_fleet_cli_tunes_a_problem_of_each_kind(spec, tmp_path):
    out = tmp_path / "fleet.json"
    res = _cli(["--problem", spec, "--backend", "virtual", "--budget", "4",
                "--out", str(out)], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    (job,) = json.loads(out.read_text())["jobs"]
    assert job["job"] == f"{spec}@h100_sxm" and job["trials"] == 4


def test_the_fleet_cli_refuses_an_unknown_system(tmp_path):
    res = _cli(["--system", "no-such-arch", "--backend", "virtual"],
               tmp_path)
    assert res.returncode != 0 and "--system" in res.stderr
