"""The port's step tuning (``repro_torch.core.step_tuner``,
``repro_torch.launch.tune``) and ``ShardingProblem(backend="compiled")``
against the JAX package's.

Parity where both price the same thing: the step space is the JAX one
configuration for configuration; for the same dry-run record (a stub
``lower_cell`` put in place of each package's, so that no test imports
``repro.launch.dryrun``, which sets ``XLA_FLAGS`` at import), the priced
evaluator's counters, stress, runtime and OOM rule, and the compiled
sharding backend's runtimes, costs and counters, equal the JAX ones bit
for bit under ``counters.TPU_NAMES``; the tune CLI's ``--problem`` mode
writes the JAX CLI's JSON (the JAX CLI run in a subprocess, the TPU spec
registered in the port under its own name).  Then the port's own flows:
the priced train → save → load → tune flow of the CLI, and the measured
backend on the CPU at SMOKE size.
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest

import repro.core.step_tuner as JS
import repro.distributed.tuning as JT
import repro.launch
import repro_torch.core.step_tuner as PS
import repro_torch.distributed.tuning as PT
import repro_torch.launch.dryrun as pdryrun
from _torch_service_sides import tpu_names  # noqa: F401  (fixture)
from repro.core import hwspec as jhw
from repro_torch.configs import SMOKES
from repro_torch.core import counters as PC
from test_torch_space_costmodel import port_spec

ROOT = Path(__file__).resolve().parents[1]


def _record(step_overrides, rules_overrides, scale=1.0):
    """A dry-run record whose numbers follow the configuration."""
    mb = (step_overrides or {}).get("microbatches", 1)
    lc = (step_overrides or {}).get("loss_chunks", 1)
    kv = (step_overrides or {}).get("kv_chunk", 1024)
    saved = (step_overrides or {}).get("remat") == "dots_saveable"
    fsdp = not rules_overrides or rules_overrides.get("embed") is not None
    seq = bool(rules_overrides and rules_overrides.get("seq"))
    tp = not (rules_overrides and rules_overrides.get("heads", 1) is None)
    chips = 256
    peak = scale * (9e9 + 40e9 / mb + 12e9 / lc - (6e9 if fsdp else 0)
                    + (8e9 if saved else 0) - (3e9 if seq else 0))
    flops = scale * 3.1e17 * (1.0 + 0.05 * math.log2(mb)) * (
        0.9 if saved else 1.0) * (1.0 + 1e-5 * kv)
    hbm = scale * 7.7e15 * (1.0 + 0.1 * lc) / (1.2 if tp else 1.0)
    coll = scale * 2.3e10 * (1.4 if fsdp else 1.0) * (1.1 if seq else 1.0)
    return {"arch": "a", "shape": "train_4k", "mesh": "single",
            "chips": chips, "status": "ok", "lower_s": 1.0,
            "compile_s": 2.0,
            "memory": {"argument_bytes": 1e9, "output_bytes": 1e9,
                       "temp_bytes": peak - 1e9, "peak_bytes": peak},
            "roofline": {"flops": flops, "hbm_bytes": hbm,
                         "collective_bytes": coll, "chips": chips,
                         "compute_s": flops / chips / 989e12,
                         "memory_s": hbm / chips / 3.35e12,
                         "collective_s": coll / 50e9,
                         "dominant": "memory", "model_flops": 1e17,
                         "useful_flops_ratio": 0.3,
                         "xla_reported_flops": 1e15,
                         "collective_by_op": {}, "collective_counts": {}}}


class _Stub:
    """A ``lower_cell`` stand-in recording its calls."""

    def __init__(self, scale=1.0):
        self.calls = []
        self.scale = scale

    def __call__(self, arch_name, shape_name, multi_pod,
                 step_overrides=None, rules_overrides=None, verbose=True):
        self.calls.append((arch_name, shape_name, multi_pod,
                           step_overrides, rules_overrides))
        return _record(step_overrides, rules_overrides, self.scale)


@pytest.fixture
def stubs(monkeypatch):
    """Each package's ``lower_cell`` replaced by a stub: the JAX one as a
    module in ``sys.modules`` (never importing ``repro.launch.dryrun``),
    the port's on its module."""
    jstub, pstub = _Stub(), _Stub()
    mod = types.ModuleType("repro.launch.dryrun")
    mod.lower_cell = jstub
    monkeypatch.setitem(sys.modules, "repro.launch.dryrun", mod)
    monkeypatch.setattr(repro.launch, "dryrun", mod, raising=False)
    monkeypatch.setattr(pdryrun, "lower_cell", pstub)
    return jstub, pstub


def _to_tpu(d):
    return {PC.TPU_NAMES[k]: v for k, v in d.items()}


def test_make_step_space_equals_the_jax_one():
    p, j = PS.make_step_space(), JS.make_step_space()
    assert p.name == j.name and len(p) == len(j) == 256
    assert [(q.name, q.values) for q in p.parameters] == \
        [(q.name, q.values) for q in j.parameters]
    assert [dict(c) for c in p] == [dict(c) for c in j]


@pytest.mark.parametrize("hbm", [16e9, 40e9])
def test_the_priced_counters_and_oom_rule_equal_the_jax_ones(stubs, hbm):
    """Every configuration of the space through both evaluators on the
    same records: the same lower_cell arguments, counters, stress and
    runtime (100x where the peak exceeds ``hbm_bytes``), bit for bit."""
    jstub, pstub = stubs
    jev = JS.CompiledStepEvaluator("qwen2.5-3b", "train_4k", hbm_bytes=hbm,
                                   verbose=False)
    pev = PS.CompiledStepEvaluator("qwen2.5-3b", "train_4k", hbm_bytes=hbm,
                                   verbose=False)
    assert PS.CompiledStepEvaluator("a", "b").hbm_bytes == 80e9
    ooms = 0
    for idx in range(len(pev.space)):
        jrt, jcs, _ = jev._evaluate(idx, True)
        prt, pcs, _ = pev._evaluate(idx, True)
        assert prt == jrt == pcs.runtime == jcs.runtime
        assert _to_tpu(pcs.ops) == jcs.ops
        assert _to_tpu(pcs.stress) == jcs.stress
        ooms += pcs.ops[PC.LOCAL_B] > 0
    assert pstub.calls == jstub.calls
    assert 0 < ooms < len(pev.space)
    # the cache: a repeat is free and lowers nothing
    n = len(pstub.calls)
    assert pev._evaluate(0, True)[2] == 0.0 and len(pstub.calls) == n


def test_the_compiled_sharding_backend_equals_the_jax_one(stubs):
    """``ShardingProblem(backend="compiled")``'s runtimes, costs and
    counters at every configuration, both profile modes, with the same
    rules overrides from FSDP, SEQ and MESH."""
    jstub, pstub = stubs
    for hw in ("tpu_v4", "tpu_v5e"):
        jp = JT.ShardingProblem("qwen2.5-3b", backend="compiled")
        pp = PT.ShardingProblem("qwen2.5-3b", backend="compiled")
        jev = jp.make_evaluator(jhw.SPECS[hw])
        pev = pp.make_evaluator(port_spec(jhw.SPECS[hw]))
        for i in range(len(pp.space())):
            for profile in (False, True):
                prt, pcs, pcost = pev(i, profile)
                jrt, jcs, jcost = jev(i, profile)
                assert prt == jrt and pcost == jcost
                assert (pcs is None) == (jcs is None) == (not profile)
                if profile:
                    assert _to_tpu(pcs.ops) == jcs.ops
                    assert _to_tpu(pcs.stress) == jcs.stress
    assert pstub.calls == jstub.calls and len(pstub.calls) == 2 * 2 * 72


def test_the_tune_cli_problem_mode_writes_the_jax_json(tpu_names, tmp_path):
    """``--problem sharding:...`` priced on the same TPU spec: the port's
    CLI (in process) and the JAX CLI (in a subprocess) write the same
    JSON, its seconds aside."""
    from repro_torch.launch import tune

    args = ["--problem", "sharding:qwen2.5-3b/train_4k", "--hw", "tpu_v5e",
            "--budget", "5", "--seed", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    theirs = tmp_path / "jax.json"
    out = subprocess.run([sys.executable, "-m", "repro.launch.tune", *args,
                          "--out", str(theirs)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ours = tmp_path / "port.json"
    assert tune.main(args + ["--out", str(ours)]) == 0
    j, p = (json.loads(f.read_text()) for f in (theirs, ours))
    j.pop("seconds"), p.pop("seconds")
    assert p == j
    assert p["trials"] == 5


def test_the_priced_train_save_load_tune_flow(monkeypatch, tmp_path,
                                              capsys):
    """The CLI's two-phase flow on the priced backend: train the TP->PC
    model on profiled tests and save it; a second run loads it, trains
    nothing, and tunes."""
    from repro_torch.launch import tune

    stub = _Stub()
    monkeypatch.setattr(pdryrun, "lower_cell", stub)
    model, out = tmp_path / "m.json", tmp_path / "t.json"
    assert tune.main(["--searcher", "profile", "--train-samples", "5",
                      "--budget", "4", "--save-model", str(model),
                      "--out", str(out)]) == 0
    first = json.loads(out.read_text())
    assert model.exists() and len(stub.calls) >= 5
    assert first["backend"] == "priced" and first["steps"] == 4
    n = len(stub.calls)
    assert tune.main(["--searcher", "profile", "--budget", "4",
                      "--load-model", str(model), "--out", str(out)]) == 0
    second = json.loads(out.read_text())
    text = capsys.readouterr().out
    assert "loaded model artifact" in text
    assert "training phase" not in text.split("loaded model artifact")[1]
    assert len(stub.calls) - n <= 4          # the tuning phase alone
    assert second["steps"] == 4
    assert second["best_ms"] == min(rt for _, rt in second["history"]) * 1e3


@pytest.fixture
def smoke(monkeypatch):
    """qwen1.5-0.5b's SMOKE config under its name; the CPU steps on one
    thread (the test workers share the CPU's cores)."""
    import torch

    import repro_torch.configs as cfgs

    archs = dict(cfgs.ARCHS, **{"qwen1.5-0.5b": SMOKES["qwen1.5-0.5b"]})
    monkeypatch.setattr(cfgs, "ARCHS", archs)
    monkeypatch.setattr(pdryrun, "ARCHS", archs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_measured_backend_on_the_cpu(smoke):
    ev = PS.MeasuredStepEvaluator("qwen1.5-0.5b", 8, 32, device="cpu",
                                  verbose=False)
    assert ev.device.type == "cpu" and ev.hbm_bytes == 80e9
    sp = ev.space
    base = {"MICROBATCHES": 1, "REMAT": "nothing_saveable",
            "LOSS_CHUNKS": 1, "KV_CHUNK": 1024, "FSDP": 0}
    i0 = sp.index_of(base)
    rt, cs, cost = ev._evaluate(i0, False)
    assert rt > 0 and cs is None and cost >= rt
    rt1, cs1, cost1 = ev._evaluate(i0, True)     # profiled: counted
    assert cs1 is not None and cs1.runtime == rt1
    assert cs1.ops[PC.FP32_FLOPS] > 0 and cs1.ops[PC.DRAM_RD] > 0
    assert cs1.ops[PC.SMEM_WS] > 0 and cs1.ops[PC.LOCAL_B] == 0.0
    assert 0 < cs1.stress[PC.DRAM_U] <= 1.0
    assert ev._evaluate(i0, True)[2] == 0.0      # cached
    i1 = sp.index_of(dict(base, MICROBATCHES=2, FSDP=1, LOSS_CHUNKS=4))
    rt2, cs2, _ = ev._evaluate(i1, True)         # the one-rank mesh
    assert rt2 > 0 and cs2.ops[PC.NVLINK_B] == 0.0
    assert [t["config"] for t in ev.tests] == [sp[i0], sp[i0], sp[i1]]
    assert all(len(t["losses"]) == PS.STEPS_TIMED
               and all(math.isfinite(x) for x in t["losses"])
               for t in ev.tests)
    assert ev.ooms == 0
    seen = []                                    # the hook sees a live step
    ev.after = lambda step, state, batch: seen.append(
        float(step(state, batch)[1]["loss"]))
    ev._evaluate(sp.index_of(dict(base, LOSS_CHUNKS=4)), False)
    assert len(seen) == 1 and math.isfinite(seen[0])
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="do not divide the batch"):
        PS.MeasuredStepEvaluator("qwen1.5-0.5b", 6, 32, device="cpu")


def test_the_measured_tune_cli_on_the_cpu(smoke, tmp_path):
    from repro_torch.launch import tune

    out = tmp_path / "t.json"
    assert tune.main(["--arch", "qwen1.5-0.5b", "--backend", "measured",
                      "--batch", "8", "--seq", "32", "--device", "cpu",
                      "--searcher", "random", "--budget", "2",
                      "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["backend"] == "measured" and rec["steps"] == 2
    assert (rec["batch"], rec["seq"]) == (8, 32)
    assert len(rec["tests"]) == 2 and rec["ooms"] == 0
    assert all(t["seconds"] > 0 for t in rec["tests"])
