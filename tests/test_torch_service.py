"""The port's tuning service (``repro_torch.service``,
``repro_torch.launch.daemon``) against the JAX package's
(``repro.service``).

Every case of ``tests/test_service.py`` (its three ``OnlineAutotuner``
cases with each package's own tuner and client), the service cases of
``tests/test_store_concurrency.py``, ``tests/test_problems.py::
test_daemon_problem_submit_end_to_end`` and ``tests/test_transfer.py::
test_daemon_surfaces_transfer_source_and_stats`` run through BOTH daemons
on ``VirtualWorkerPool`` with the same requests (``both``): each side makes
the JAX test's assertions, and the two transcripts — every response, the
tenant snapshots, ``stats``, the store's contents — must be equal.

Beside parity: the wire constants and validators are the JAX package's
source; a JAX client drives a live port daemon and a port client a live
JAX daemon; a daemon over a pool measuring on the CPU answers through
``DeviceKernelEvaluator`` and refuses hardware it has no card of before
any test and prices a serve-kind submit in its own process;
unported problem-kind submits and a JAX corpus are refused; the daemon
CLI prices, measures on the CPU when asked, and
refuses to start without a card.  Every socket, join and subprocess has a
timeout of its own.
"""
import dataclasses
import inspect
import multiprocessing
import os
import socket as socketlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch  # noqa: F401

from _torch_service_sides import (HW, JAX, PORT, both, drive, final_state,
                                  make_daemon, scrub, stats, store_state,
                                  submit_kernel, tpu_names)
from _torch_service_writer import sharded_daemon_writer

pytestmark = pytest.mark.usefixtures("tpu_names")
assert tpu_names
ROOT = Path(__file__).resolve().parents[1]


def _errors(fn, *cases):
    """``(type, message, code)`` of what ``fn`` raises on each case (None
    where it returns)."""
    out = []
    for case in cases:
        try:
            fn(case)
            out.append(None)
        except Exception as exc:       # the type name is compared
            out.append((type(exc).__name__, str(exc),
                        getattr(exc, "code", None)))
    return out


# =============================================================================
# Wire protocol: the JAX package's, byte for byte
# =============================================================================
WIRE = ("PROTOCOL", "PROTOCOL_VERSION", "MAX_LINE_BYTES", "OPS",
        "SUBMIT_KINDS", "E_BAD_REQUEST", "E_UNKNOWN_OP",
        "E_UNKNOWN_REQUEST", "E_UNKNOWN_KERNEL", "E_UNKNOWN_PROBLEM",
        "E_ADMISSION", "E_BUDGET", "E_DRAINING", "E_NOT_DONE", "E_INTERNAL")
CODE = ("ProtocolError", "encode", "decode", "ok", "err", "_want",
        "_want_num_list", "_validate_submit", "validate_request",
        "read_line")


def test_the_wire_constants_are_the_jax_packages():
    for name in WIRE:
        assert getattr(PORT.P, name) == getattr(JAX.P, name), name
    assert PORT.P.PROTOCOL == "repro.tuning-service"
    assert PORT.P.PROTOCOL_VERSION == 2


@pytest.mark.parametrize("name", CODE)
def test_the_wire_code_is_the_jax_packages(name):
    assert inspect.getsource(getattr(PORT.P, name)) == \
        inspect.getsource(getattr(JAX.P, name))


def _protocol_roundtrip(S, root):
    msg = {"op": "ping"}
    assert S.P.decode(S.P.encode(msg)) == msg
    return S.P.encode({"op": "submit", "tenant": "t", "b": [1, 2]})


def _protocol_rejects_garbage(S, root):
    out = _errors(S.P.decode, b"not json\n", b"[1, 2]\n")
    out += _errors(S.P.validate_request, {"op": "frobnicate"}, {})
    assert None not in out
    return out


def _protocol_submit_kernel_validation(S, root):
    req = S.P.validate_request({"op": "submit", "tenant": "t",
                                "kind": "kernel", "kernel": "matmul",
                                "hardware": HW})
    assert req["seed"] == 0 and req["budget"] is None
    errs = _errors(S.P.validate_request, *(
        {"op": "submit", "kind": "kernel", "kernel": "matmul",
         "hardware": HW},                             # no tenant
        {"op": "submit", "tenant": "", "kind": "kernel",
         "kernel": "matmul", "hardware": HW},         # empty tenant
        {"op": "submit", "tenant": "t", "kind": "kernel",
         "hardware": HW},                             # no kernel
        {"op": "submit", "tenant": "t", "kind": "kernel",
         "kernel": "matmul", "hardware": HW, "budget": 0},
        {"op": "submit", "tenant": "t", "kind": "kernel",
         "kernel": "matmul", "hardware": HW, "budget": True},
        {"op": "submit", "tenant": "t", "kind": "wat",
         "kernel": "matmul", "hardware": HW}))
    assert None not in errs
    return [req, errs]


def _protocol_submit_serve_validation(S, root):
    base = {"op": "submit", "kind": "serve", "tenant": "t", "hardware": HW,
            "bucket": "p1n1", "bucket_shape": [16, 6],
            "batch_sizes": [1, 2, 4], "max_seqs": [32, 64]}
    req = S.P.validate_request(base)
    assert req["space"] == "serve_online" and req["calib_n"] == 16
    errs = _errors(S.P.validate_request,
                   {**base, "bucket_shape": [16]},
                   {**base, "batch_sizes": []},
                   {**base, "max_seqs": [32, -1]})
    assert None not in errs
    return [req, errs]


def _protocol_request_id_ops(S, root):
    out = []
    for op in ("status", "result", "cancel"):
        got = S.P.validate_request({"op": op, "request_id": "r1"})
        assert got == {"op": op, "request_id": "r1"}
        errs = _errors(S.P.validate_request, {"op": op})
        assert None not in errs
        out.append([got, errs])
    return out


# =============================================================================
# Sharded store
# =============================================================================
def _files(root):
    return sorted(os.listdir(root))


def _sharded_store_api_parity(S, root):
    root = os.path.join(root, "corpus")
    store = S.service.ShardedConfigStore(root, n_shards=3)
    keys = [("sp", f"b{i}", hw) for i in range(4)
            for hw in ("tpu_v4", "tpu_v5e")]
    for i, (s, b, h) in enumerate(keys):
        store.put(s, b, h, config={"X": i}, runtime=float(i + 1), trials=i)
    assert len(store) == len(keys)
    shard_files = [f for f in os.listdir(root) if f.startswith("shard-")]
    assert len(shard_files) > 1
    reopened = S.service.ShardedConfigStore(root)
    assert reopened.n_shards == 3
    for i, (s, b, h) in enumerate(keys):
        e = reopened.get(s, b, h)
        assert e is not None and e.config == {"X": i}
    assert {e.key for e in reopened.entries()} == \
        {f"kernel|{s}|{b}|{h}" for s, b, h in keys}
    return [_files(root), store_state(S, reopened)]


def _sharded_store_nearest_model_tiers(S, root):
    store = S.service.ShardedConfigStore(os.path.join(root, "c"),
                                         n_shards=4)
    art = {"format": "repro.tppc_model"}
    store.put_model_dict("sp", "bucketA", "hw1", dict(art))
    store.put_model_dict("sp", "bucketB", "hw2", dict(art))
    got = [store.nearest_model_key("sp", "bucketA", "hw1"),
           store.nearest_model_key("sp", "bucketA", "hw2"),
           store.nearest_model_key("sp", "bucketC", "hw2"),
           store.nearest_model_key("other", "bucketA", "hw1")]
    assert got == ["kernel|sp|bucketA|hw1", "kernel|sp|bucketA|hw1",
                   "kernel|sp|bucketB|hw2", None]
    return [got, store_state(S, store)]


def _sharded_store_batched_save_flushes_dirty_shards(S, root):
    root = os.path.join(root, "c")
    store = S.service.ShardedConfigStore(root, n_shards=4, autosave=False)
    store.put("sp", "b1", "hw", config={"X": 1}, runtime=1.0, trials=1)
    store.put("sp", "b2", "hw", config={"X": 2}, runtime=2.0, trials=1)
    before = len(S.service.ShardedConfigStore(root))
    assert before == 0
    store.save()
    after = S.service.ShardedConfigStore(root)
    assert len(after) == 2
    return [_files(root), store_state(S, after)]


def _sharded_store_prune_aggregates(S, root):
    root = os.path.join(root, "c")
    store = S.service.ShardedConfigStore(root, n_shards=3)
    for hw in ("tpu_v4", "tpu_v5e"):
        for b in ("b1", "b2", "b3"):
            store.put("sp", b, hw, config={}, runtime=1.0, trials=1)
    preview = store.prune(keep_hardware={"tpu_v4"}, dry_run=True)
    assert preview["dropped_entries"] == 3 and len(store) == 6
    pruned = store.prune(keep_hardware={"tpu_v4"})
    assert pruned == preview and len(store) == 3
    again = S.service.ShardedConfigStore(root)
    assert len(again) == 3
    return [preview, pruned, store_state(S, again)]


# =============================================================================
# Tenant policy
# =============================================================================
def _tenant_admission_limits(S, root):
    tm = S.tenants.TenantManager(max_tenants=2, max_queued_per_tenant=1)
    a = tm.admit("a")
    tm.admit("b")
    out = _errors(tm.admit, "c")
    tm.check_submit(a)
    a.queued = 1
    out += _errors(tm.check_submit, a)
    assert out[0] is not None and out[1] is not None
    return [out, tm.snapshot()]


def _tenant_budget_exhaustion_and_topup(S, root):
    tm = S.tenants.TenantManager()
    ts = tm.admit("t", budget_s=1.0)
    tm.charge(ts, 0.6)
    tm.check_submit(ts)
    tm.charge(ts, 0.6)
    assert ts.exhausted
    out = _errors(tm.check_submit, ts)
    assert out[0][2] == S.P.E_BUDGET
    snap = tm.snapshot()
    tm.admit("t", budget_s=10.0)
    assert not ts.exhausted
    tm.check_submit(ts)
    return [out, snap, tm.snapshot()]


def _tenant_fairness_least_spent_first(S, root):
    tm = S.tenants.TenantManager()
    for name, spend in (("hog", 9.0), ("mid", 1.0), ("new", 0.0)):
        tm.charge(tm.admit(name), spend)
    order = tm.fairness_order(["hog", "mid", "new"])
    assert order == ["new", "mid", "hog"]
    return [order, tm.snapshot()]


# =============================================================================
# Daemon, driven in process (no sockets, no loop thread)
# =============================================================================
def _daemon_cold_then_store_hit(S, root):
    d = make_daemon(S)
    r1 = submit_kernel(S, d, "a")
    assert r1["ok"] and r1["state"] == "queued"
    rid = r1["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    res = d.handle({"op": "result", "request_id": rid})
    assert res["ok"] and res["trials"] == 6 and res["source"] == "tuned"
    r2 = submit_kernel(S, d, "b")
    assert r2["state"] == "done" and r2["trials"] == 0
    assert r2["source"] == "store" and r2["config"] == res["config"]
    return [r1, res, r2, final_state(S, d)]


def _daemon_coalesces_identical_inflight_requests(S, root):
    d = make_daemon(S)
    r1 = submit_kernel(S, d, "a")
    r2 = submit_kernel(S, d, "b")
    assert r2["coalesced"] == r1["request_id"]
    drive(d, lambda: d._records[r2["request_id"]].state == "done")
    res = d.handle({"op": "result", "request_id": r2["request_id"]})
    assert res["trials"] == 0 and res["source"] == "coalesced"
    assert d.tenants.get("b").spent_s == 0.0
    assert d.tenants.get("a").spent_s > 0.0
    return [r1, r2, res, final_state(S, d)]


def _daemon_unknown_kernel_and_request(S, root):
    d = make_daemon(S)
    out = [submit_kernel(S, d, "a", kernel="no_such_kernel")]
    assert not out[0]["ok"] and out[0]["code"] == S.P.E_UNKNOWN_KERNEL
    for op in ("status", "result", "cancel"):
        r = d.handle({"op": op, "request_id": "r999999"})
        assert not r["ok"] and r["code"] == S.P.E_UNKNOWN_REQUEST
        out.append(r)
    return [out, final_state(S, d)]


def _daemon_cancel_queued_and_running(S, root):
    d = make_daemon(S, max_active_jobs=1)
    r1 = submit_kernel(S, d, "a", kernel="matmul")
    r2 = submit_kernel(S, d, "a", kernel="transpose", input=None)
    d._admit_pending()
    c2 = d.handle({"op": "cancel", "request_id": r2["request_id"]})
    assert c2["cancelled"]
    assert d._records[r2["request_id"]].state == "cancelled"
    d.tuner.step(max_wait=0.01)
    c1 = d.handle({"op": "cancel", "request_id": r1["request_id"]})
    assert c1["cancelled"]
    assert d._records[r1["request_id"]].state == "cancelled"
    res = d.handle({"op": "result", "request_id": r1["request_id"]})
    assert not res["ok"] and res["code"] == S.P.E_NOT_DONE
    assert len(d.store) == 0
    return [r1, r2, c2, c1, res, final_state(S, d)]


def _daemon_meters_and_parks_over_budget_tenant(S, root):
    d = make_daemon(S, tenants=S.tenants.TenantManager(
        max_active_per_tenant=1))
    rp = submit_kernel(S, d, "poor", kernel="matmul", tenant_budget_s=1e-7)
    rq = submit_kernel(S, d, "poor", kernel="transpose", input=None)
    rr = submit_kernel(S, d, "rich", kernel="conv2d", input=None)

    def done(rid):
        return d._records[rid].state in ("done", "cancelled")

    drive(d, lambda: done(rp["request_id"]) and done(rr["request_id"]))
    poor = d.tenants.get("poor")
    assert poor.exhausted and poor.spent_s > 1e-7
    d._admit_pending()
    assert d._records[rq["request_id"]].state == "parked"
    r4 = submit_kernel(S, d, "poor", kernel="attention", input=None)
    assert not r4["ok"] and r4["code"] == S.P.E_BUDGET
    assert d._records[rr["request_id"]].state == "done"
    assert not d.tenants.get("rich").exhausted
    recs = [d._records[r["request_id"]] for r in (rp, rq)]
    assert abs(sum(r.spent_s for r in recs) - poor.spent_s) < 1e-9
    statuses = [d.handle({"op": "status", "request_id": r["request_id"]})
                for r in (rp, rq, rr)]
    return [rp, rq, rr, r4, statuses, final_state(S, d)]


def _daemon_drain_resolves_running_as_cancelled(S, root):
    d = make_daemon(S)
    r1 = submit_kernel(S, d, "a", budget=50)
    d._admit_pending()
    d.tuner.step(max_wait=0.01)
    d._draining = True
    d.tuner.stop()
    while d.tuner.step(max_wait=0.01):
        pass
    rep = d.tuner.finish()
    rec = d._records[r1["request_id"]]
    assert rec.state == "cancelled"
    assert rep.results and rep.results[0].cancelled
    assert 0 < rec.trials < 50
    return [r1, d.handle({"op": "status", "request_id": r1["request_id"]}),
            [(r.trials, r.history, r.cancelled) for r in rep.results],
            d.tenants.snapshot(), store_state(S, d.store)]


def _daemon_stats_shape(S, root):
    d = make_daemon(S)
    r = submit_kernel(S, d, "a")
    st = stats(d)
    assert st["ok"] and not st["draining"]
    assert st["fleet"]["jobs"] == 0
    assert "a" in st["tenants"]
    assert st["requests"] == {"queued": 1}
    return [r, st]


# =============================================================================
# Daemon over a real socket (threaded loop + client)
# =============================================================================
def _live(S, root, **kw):
    store = S.service.ShardedConfigStore(os.path.join(root, "corpus"),
                                         n_shards=2)
    d = S.service.TuningDaemon(S.fleet.VirtualWorkerPool(workers=4), store,
                               default_trial_budget=6, **kw)
    d.start()
    return d


def _stop(d):
    d.shutdown(drain=False)
    assert d.wait(timeout=60)


def _daemon_socket_end_to_end(S, root):
    d = _live(S, root)
    try:
        with S.client.ServiceClient(d.address, timeout=30) as c:
            ping = c.ping()
            assert ping["version"] == S.P.PROTOCOL_VERSION
            r = c.submit_kernel("a", "matmul", HW, input="2048")
            res = c.result(r["request_id"], timeout=120)
            assert res["state"] == "done" and res["trials"] == 6
            repeat = c.submit_kernel("other-tenant", "matmul", HW,
                                     input="2048")
            assert repeat["state"] == "done" and repeat["trials"] == 0
            st = c.stats()
            assert st["tenants"]["other-tenant"]["store_hits"] == 1
            assert st["store_entries"] >= 1
        return [ping, r, res, repeat, st["tenants"], st["requests"],
                st["sources"], st["store_entries"]]
    finally:
        _stop(d)


def _daemon_socket_rejects_malformed_line(S, root):
    d = _live(S, root)
    try:
        with socketlib.create_connection(d.address, timeout=10) as s:
            s.sendall(b"this is not json\n")
            resp = S.P.decode(s.makefile("rb").readline())
            assert not resp["ok"] and resp["code"] == S.P.E_BAD_REQUEST
        return resp
    finally:
        _stop(d)


def _daemon_socket_drain_shutdown(S, root):
    d = _live(S, root)
    try:
        with S.client.ServiceClient(d.address, timeout=30) as c:
            resp = c.shutdown(drain=True)
            assert resp["draining"]
            assert d.wait(timeout=60)
            with pytest.raises(S.client.ServiceError):
                S.client.ServiceClient(d.address, timeout=5,
                                       retries=1).ping()
        return resp
    finally:
        _stop(d)


# =============================================================================
# Sharded corpus shared by daemon processes (test_store_concurrency.py)
# =============================================================================
def _concurrent_daemons_share_sharded_corpus(S, root):
    root = os.path.join(root, "corpus")
    # spawned, not forked: this process runs JAX's threads
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=sharded_daemon_writer,
                         args=("repro_torch" if S.port else "repro", root,
                               tag, barrier))
             for tag in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    merged = S.service.ShardedConfigStore(root, n_shards=3)
    assert len(merged) == 3
    shared = merged.get("sp", "shared", "hw")
    assert shared is not None and shared.runtime == 1.0
    model = merged.get_model_dict("sp", "shared", "hw")
    assert model["revision"] == 11 and model["tag"] == 1
    return store_state(S, merged)


def _sharded_corpus_shard_count_agreement(S, root):
    root = os.path.join(root, "corpus")
    first = S.service.ShardedConfigStore(root, n_shards=5)
    second = S.service.ShardedConfigStore(root, n_shards=2)
    assert first.n_shards == second.n_shards == 5
    first.put("sp", "b", "hw", config={"X": 1}, runtime=1.0, trials=1)
    again = S.service.ShardedConfigStore(root)
    assert again.get("sp", "b", "hw") is not None
    return [_files(root), store_state(S, again)]


# =============================================================================
# test_problems.py / test_transfer.py daemon cases
# =============================================================================
def _daemon_problem_submit_end_to_end(S, root):
    d = S.service.TuningDaemon(S.fleet.VirtualWorkerPool(workers=2),
                               S.tuning.ConfigStore(),
                               default_trial_budget=5)
    d.start()
    try:
        with S.client.ServiceClient(d.address, timeout=30) as c:
            r = c.submit_problem("t", "kernel:matmul/2048", HW)
            res = c.result(r["request_id"], timeout=120)
            assert res["state"] == "done" and res["trials"] == 5
            repeat = c.submit_problem("t2", "kernel:matmul/2048", HW)
            assert repeat["state"] == "done" and repeat["trials"] == 0
            r2 = c.submit_problem("t", "serve:p1n1", HW,
                                  params={"arch": "qwen2.5-3b"}, budget=4)
            res2 = c.result(r2["request_id"], timeout=120)
            assert res2["state"] == "done" and res2["trials"] == 4
            codes = []
            for spec in ("wat:thing", "no-colon"):
                with pytest.raises(S.client.ServiceError) as ei:
                    c.submit_problem("t", spec, HW)
                assert ei.value.code == S.P.E_UNKNOWN_PROBLEM
                codes.append(ei.value.code)
        return [r, res, repeat, r2, res2, codes]
    finally:
        _stop(d)


def _trained_store(S, kernel, hw):
    """A store holding the TP→PC model trained (deliberate sample) on the
    kernel's default input, as ``test_transfer._store_with_kernel_models``
    builds it."""
    from repro.core import hwspec as jhw
    from repro_torch.core import hwspec as phw

    problem = S.tuning.make_problem("kernel", kernel)
    space = problem.space()
    spec = (phw if S.port else jhw).get(hw)
    model = S.tuning.TuningSession(space, problem.workload_fn(), hw=spec,
                                   seed=0).train(kind="tree",
                                                 sample="deliberate")
    store = S.tuning.ConfigStore()
    store.save_model(space.name, "default", hw, model, space, kind="kernel")
    return store


def _daemon_surfaces_transfer_source_and_stats(S, root):
    d = make_daemon(S, store=_trained_store(S, "matmul", "tpu_v5e"))
    r = submit_kernel(S, d, "t", kernel="conv2d", input="4096",
                      hw="tpu_v5e")
    assert r["ok"]
    rid = r["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    res = d.handle({"op": "result", "request_id": rid})
    assert res["ok"] and res["source"] == "transfer"
    assert res["transfer_from"] is not None and res["warm_started"]
    st = stats(d)
    assert st["transfers"] == 1 and st["sources"].get("transfer") == 1
    return [r, res, final_state(S, d)]


# =============================================================================
# test_service.py serve-kind cases
# =============================================================================
def _daemon_serve_kind_submit(S, root):
    d = make_daemon(S, store=S.service.ShardedConfigStore(
        os.path.join(root, "c"), n_shards=2))
    r = d.handle(S.P.validate_request({
        "op": "submit", "kind": "serve", "tenant": "engine-1",
        "hardware": HW, "bucket": "p2n2", "bucket_shape": [40, 12],
        "batch_sizes": [1, 2, 4, 8, 16], "max_seqs": [32, 64, 96, 128]}))
    rid = r["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    res = d.handle({"op": "result", "request_id": rid})
    assert res["ok"]
    assert res["config"]["MAX_SEQ"] >= 40 + 12
    entry = d.store.get("serve_online", "p2n2", HW, kind="serve")
    assert entry is not None and entry.config == res["config"]
    return [r, res, final_state(S, d)]


def _hwspec(S):
    if S.port:
        from repro_torch.core import hwspec
    else:
        from repro.core import hwspec
    return hwspec


def _daemon_serve_kind_unregistered_hardware_ships_spec(S, root):
    """A replica labelled outside the registry ships its pricing spec (each
    package's own fields); without it the submit is refused."""
    hwspec = _hwspec(S)
    d = make_daemon(S)
    base = dict(op="submit", kind="serve", tenant="replica",
                hardware="cpu", bucket="p2n2", bucket_shape=[40, 12],
                batch_sizes=[1, 2, 4, 8], max_seqs=[64, 96, 128])
    r0 = d.handle(S.P.validate_request(dict(base)))
    assert not r0["ok"] and r0["code"] == S.P.E_BAD_REQUEST
    spec = dataclasses.replace(hwspec.SPECS[HW], name="cpu")
    r = d.handle(S.P.validate_request(dict(
        base, hardware_spec=dataclasses.asdict(spec))))
    rid = r["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    res = d.handle({"op": "result", "request_id": rid})
    assert res["ok"] and res["config"]["MAX_SEQ"] >= 40 + 12
    entry = d.store.get("serve_online", "p2n2", hwspec.fingerprint(spec),
                        kind="serve")
    assert entry is not None and entry.config == res["config"]
    r2 = d.handle(S.P.validate_request(dict(
        base, hardware_spec=dataclasses.asdict(spec))))
    assert r2["state"] == "done" and r2["trials"] == 0
    return [r0["code"], r, res, r2, hwspec.fingerprint(spec),
            final_state(S, d)]


def _serve_tuner(S, service, hardware_name=HW, **kw):
    if S.port:
        import repro_torch.serve.autotune as A
    else:
        import repro.serve.autotune as A
    hw = _hwspec(S).get(HW)
    stats = A.ServeWorkloadStats()
    backend = A.SyntheticServeBackend(hw, stats, seed=1)
    return backend, A.OnlineAutotuner(
        backend, store=S.tuning.ConfigStore(), space=A.serve_space(), hw=hw,
        stats=stats, hardware_name=hardware_name, service=service,
        max_live_trials=6, **kw)


def _serve_requests(S, n=8, plen=20, new=8):
    if S.port:
        from repro_torch.serve.engine import Request
    else:
        from repro.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(1, 100, size=plen),
                    max_new_tokens=new) for i in range(n)]


def _report(rep):
    return [rep.bucket, rep.drift, rep.reused, rep.live_trials, rep.config,
            [list(h) for h in rep.history], rep.via_service]


def _online_autotuner_routes_via_service(S, root):
    d = _live(S, root)
    try:
        backend, tuner = _serve_tuner(S, f"127.0.0.1:{d.port}")
        _, rep = tuner.serve(_serve_requests(S))
        assert rep.via_service and not rep.reused and rep.live_trials == 0
        assert backend.measure_calls == 0
        _, rep2 = tuner.serve(_serve_requests(S))
        assert not rep2.drift
        tuner._active = None                 # force a re-ensure
        _, rep3 = tuner.serve(_serve_requests(S))
        assert rep3.reused and not rep3.via_service
        return [_report(r) for r in (rep, rep2, rep3)] + [
            store_state(S, tuner.store)]
    finally:
        _stop(d)


def _online_autotuner_falls_back_when_unreachable(S, root):
    backend, tuner = _serve_tuner(S, "127.0.0.1:1", service_timeout=2.0)
    _, rep = tuner.serve(_serve_requests(S))
    assert not rep.via_service and rep.live_trials > 0
    assert backend.measure_calls == rep.live_trials
    return [_report(rep), backend.measure_calls]


def _online_autotuner_routes_with_unregistered_hardware(S, root):
    d = _live(S, root)
    try:
        backend, tuner = _serve_tuner(S, f"127.0.0.1:{d.port}",
                                      hardware_name="cpu")
        _, rep = tuner.serve(_serve_requests(S))
        assert rep.via_service and rep.live_trials == 0
        assert backend.measure_calls == 0
        assert tuner.store.get(tuner.space.name, rep.bucket, "cpu",
                               kind="serve") is not None
        return [_report(rep), store_state(S, tuner.store)]
    finally:
        _stop(d)


CASES = {f.__name__[1:]: f for f in (
    _protocol_roundtrip, _protocol_rejects_garbage,
    _protocol_submit_kernel_validation, _protocol_submit_serve_validation,
    _protocol_request_id_ops,
    _sharded_store_api_parity, _sharded_store_nearest_model_tiers,
    _sharded_store_batched_save_flushes_dirty_shards,
    _sharded_store_prune_aggregates,
    _tenant_admission_limits, _tenant_budget_exhaustion_and_topup,
    _tenant_fairness_least_spent_first,
    _daemon_cold_then_store_hit,
    _daemon_coalesces_identical_inflight_requests,
    _daemon_unknown_kernel_and_request, _daemon_cancel_queued_and_running,
    _daemon_meters_and_parks_over_budget_tenant,
    _daemon_drain_resolves_running_as_cancelled, _daemon_stats_shape,
    _daemon_socket_end_to_end, _daemon_socket_rejects_malformed_line,
    _daemon_socket_drain_shutdown,
    _concurrent_daemons_share_sharded_corpus,
    _sharded_corpus_shard_count_agreement,
    _daemon_problem_submit_end_to_end,
    _daemon_surfaces_transfer_source_and_stats,
    _daemon_serve_kind_submit,
    _daemon_serve_kind_unregistered_hardware_ships_spec,
    _online_autotuner_routes_via_service,
    _online_autotuner_falls_back_when_unreachable,
    _online_autotuner_routes_with_unregistered_hardware)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_answers_as_the_jax_service_does(case, tmp_path):
    jax_side, port_side = both(CASES[case], tmp_path)
    assert port_side == jax_side


# =============================================================================
# Cross-wire: each package's client against the other's live daemon
# =============================================================================
def _conversation(client_mod, address):
    """Two tenants' conversation: ping, a cold kernel submit to its
    result, a store hit, a submit warm-started by transfer from the first
    one's published model, its status, an unknown kernel."""
    out = []
    with client_mod.ServiceClient(address, timeout=30) as c:
        out.append(c.ping())
        r = c.submit_kernel("a", "matmul", HW, input="2048", budget=5)
        out += [r, c.result(r["request_id"], timeout=120)]
        out.append(c.submit_kernel("b", "matmul", HW, input="2048"))
        t = c.submit_kernel("b", "conv2d", "tpu_v5e", input="4096",
                            budget=4, tenant_budget_s=100.0)
        out += [t, c.result(t["request_id"], timeout=120),
                c.status(t["request_id"])]
        with pytest.raises(client_mod.ServiceError) as ei:
            c.submit_kernel("a", "no_such_kernel", HW)
        out.append(ei.value.code)
        st = c.stats()
        out += [st["tenants"], st["requests"], st["sources"]]
    return out


@pytest.mark.parametrize("client,daemon", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-client-port-daemon",
                              "port-client-jax-daemon"])
def test_a_client_of_either_package_talks_to_a_daemon_of_the_other(
        client, daemon, tmp_path):
    answers = []
    for c, d in ((client, daemon), (daemon, daemon)):
        # trained inline: the conv2d job warm-starts from the published
        # GEMM model in both conversations
        live = _live(d, str(tmp_path / f"{c.name}-{d.name}"),
                     train_async=False)
        try:
            answers.append(scrub(_conversation(c.client, live.address)))
        finally:
            _stop(live)
    assert answers[0] == answers[1]
    assert answers[0][2]["trials"] == 5 and answers[0][3]["trials"] == 0
    assert answers[0][5]["source"] == "transfer"
    assert answers[0][5]["transfer_from"] == "kernel|gemm|2048|tpu_v4"


# =============================================================================
# Measured: a pool with devices
# =============================================================================
def _measuring_daemon(monkeypatch, **kw):
    """A daemon over a one-thread pool measuring on the CPU (the plain
    versions), with every ``DeviceKernelEvaluator`` it builds recorded and
    the cost model refusing to price anything."""
    from repro_torch.core import evaluate as pev

    built = []

    class Recording(pev.DeviceKernelEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    def refuse(*a, **k):
        raise AssertionError("a measuring daemon priced a test")

    monkeypatch.setattr(pev, "DeviceKernelEvaluator", Recording)
    monkeypatch.setattr("repro_torch.fleet.tuner.costmodel.execute", refuse)
    d = PORT.service.TuningDaemon(
        PORT.fleet.ThreadWorkerPool(workers=1, devices=["cpu"]),
        PORT.tuning.ConfigStore(), default_trial_budget=3,
        publish_models=False, **kw)
    d.tuner.begin()
    return d, built


def test_a_measuring_daemon_answers_through_the_card_evaluator(monkeypatch):
    d, built = _measuring_daemon(monkeypatch)
    try:
        assert [(dev, spec.name) for dev, spec in d.cards] == \
            [("cpu", "h100_sxm")]
        r = submit_kernel(PORT, d, "a", kernel="matmul", input="128",
                          hw="H100-SXM")
        assert r["ok"] and r["state"] == "queued"
        rec = d._records[r["request_id"]]
        assert rec.job.measured and rec.job.device == "cpu"
        assert rec.key == "kernel|gemm|128|h100_sxm"
        drive(d, lambda: rec.state == "done", max_iters=5000)
        res = d.handle({"op": "result", "request_id": rec.rid})
        assert res["ok"] and res["trials"] == 3 and res["source"] == "tuned"
        assert np.isfinite(res["runtime"]) and res["runtime"] > 0
        assert len(built) == 1 and built[0].device_name == "cpu"
        assert len(built[0].measured) == 3
        assert d.tenants.get("a").spent_s > 0
        again = submit_kernel(PORT, d, "b", kernel="matmul", input="128",
                              hw="h100_sxm")
        assert again["state"] == "done" and again["trials"] == 0
        assert len(built) == 1
    finally:
        d.pool.close()


@pytest.mark.parametrize("hw", ["h100_pcie", "tpu_v4", "no_such_card"])
def test_a_measuring_daemon_refuses_hardware_it_has_no_card_of(
        monkeypatch, hw):
    d, built = _measuring_daemon(monkeypatch)
    try:
        r = submit_kernel(PORT, d, "a", kernel="matmul", input="128", hw=hw)
        assert not r["ok"] and r["code"] == PORT.P.E_BAD_REQUEST
        assert "no card of" in r["error"] and "cpu (h100_sxm)" in r["error"]
        assert d._records == {} and not d._pending
        assert d.tenants.get("a").rejected == 1
        for _ in range(5):
            d._admit_pending()
            assert not d.tuner.step(max_wait=0.01)
        assert built == [] and d.tuner.progress()["jobs"] == 0
    finally:
        d.pool.close()


def test_a_measuring_daemon_places_jobs_on_its_cards_in_turn(monkeypatch):
    from repro_torch.core import hwspec

    monkeypatch.setattr(hwspec, "detect", lambda index=0: hwspec.H100_SXM)
    pool = PORT.fleet.ThreadWorkerPool(workers=2,
                                       devices=["cuda:0", "cuda:1"])
    d = PORT.service.TuningDaemon(pool, PORT.tuning.ConfigStore())
    try:
        assert [dev for dev, _ in d.cards] == ["cuda:0", "cuda:1"]
        devices = []
        for kernel, inp in (("matmul", "128"), ("matmul", "2048"),
                            ("conv2d", "4096")):
            r = submit_kernel(PORT, d, "a", kernel=kernel, input=inp,
                              hw="h100_sxm")
            devices.append(d._records[r["request_id"]].job.device)
        assert devices == ["cuda:0", "cuda:1", "cuda:0"]
        r = submit_kernel(PORT, d, "a", kernel="matmul", input="128",
                          hw="h100_pcie")
        assert not r["ok"] and "no card of 'h100_pcie'" in r["error"]
    finally:
        pool.close()


def test_a_status_is_answered_while_a_measured_job_runs(monkeypatch):
    """While a measured test is held in flight, ``status`` ops over the
    socket are answered and show the trials already done."""
    from repro_torch.core import evaluate as pev

    real = pev.DeviceKernelEvaluator._evaluate
    held, release = threading.Event(), threading.Event()
    calls = []

    def hold_the_third(self, index, profile):
        calls.append(index)
        if len(calls) == 3:
            held.set()
            assert release.wait(timeout=60)
        return real(self, index, profile)

    monkeypatch.setattr(pev.DeviceKernelEvaluator, "_evaluate",
                        hold_the_third)
    pool = PORT.fleet.ThreadWorkerPool(workers=1, devices=["cpu"])
    d = PORT.service.TuningDaemon(pool, PORT.tuning.ConfigStore(),
                                  default_trial_budget=5, in_flight=1,
                                  publish_models=False)
    d.start()
    try:
        with PORT.client.ServiceClient(d.address, timeout=10) as c:
            rid = c.submit_kernel("a", "matmul", "h100_sxm",
                                  input="128")["request_id"]
            assert held.wait(timeout=60)
            for _ in range(5):
                st = c.status(rid)
                assert st["state"] == "running" and st["trials"] == 2, st
            release.set()
            assert c.result(rid, timeout=60)["trials"] == 5
    finally:
        release.set()
        _stop(d)
        pool.close()


def test_the_fleet_loop_lets_waiting_request_ops_in_before_its_next_tick():
    """Each tick makes progress (as on a card) and a request op waits for
    the lock while it runs: the op is answered before the next tick, every
    time, instead of the loop taking the lock straight back."""
    d = make_daemon(PORT)
    order, ops, threads = [], [], []
    real_step = d.tuner.step

    def step(max_wait=None):
        if len(order) >= 10:
            return real_step(max_wait=max_wait)
        order.append("tick")
        asked = d._asked
        t = threading.Thread(target=lambda: ops.append(
            d.handle({"op": "stats"})["ok"]))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 30
        while d._asked == asked and time.monotonic() < deadline:
            time.sleep(0.0005)      # the op now waits for the lock
        return True

    real_stats = d._op_stats

    def stats():
        order.append("op")
        return real_stats()

    d.tuner.step = step
    d._op_stats = stats
    d.start()
    try:
        deadline = time.monotonic() + 60
        while len(order) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        _stop(d)
        for t in threads:
            t.join(timeout=30)
    assert order[:10] == ["tick", "op"] * 5
    assert ops and all(ops)


def test_request_ops_from_many_threads_are_all_let_in(tmp_path):
    """Sixteen threads of status and stats ops against a live daemon
    whose loop keeps stepping, with the interpreter switching threads
    every microsecond: every op is answered and none stays counted as
    waiting for the lock."""
    d = _live(PORT, str(tmp_path))
    errors, answered = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rid = d.handle(PORT.P.validate_request(dict(
            op="submit", kind="kernel", tenant="t", kernel="matmul",
            input="2048", hardware=HW, budget=40)))["request_id"]

        def caller():
            try:
                for n in range(20):
                    op = {"op": "status", "request_id": rid} if n % 2 \
                        else {"op": "stats"}
                    answered.append(d.handle(op)["ok"])
            except Exception as exc:
                errors.append(repr(exc))

        threads = [threading.Thread(target=caller) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        _stop(d)
    assert not errors and answered == [True] * 320
    assert d._let_in == d._asked


def test_a_priced_daemon_has_no_cards():
    d = make_daemon(PORT)
    assert d.cards == []
    sub = PORT.fleet.SubprocessWorkerPool.__new__(
        PORT.fleet.SubprocessWorkerPool)
    sub.devices = [None, None]             # lanes that price
    from repro_torch.service.daemon import _pool_cards
    assert _pool_cards(sub) == []


# =============================================================================
# Refusals
# =============================================================================
def test_a_serve_kind_submit_is_refused_naming_the_serving_autotuner():
    """A serve-kind submit whose bucket is no serve bucket key is refused
    before it becomes a job, by the serving autotuner's ``ServeProblem``
    (the serve kind itself is answered: ``_daemon_serve_kind_submit``)."""
    d = make_daemon(PORT)
    r = d.handle(PORT.P.validate_request({
        "op": "submit", "kind": "serve", "tenant": "engine-1",
        "hardware": HW, "bucket": "p2x2", "bucket_shape": [40, 12],
        "batch_sizes": [1, 2, 4], "max_seqs": [32, 64]}))
    assert not r["ok"] and r["code"] == PORT.P.E_BAD_REQUEST
    assert "serve problem name must be a bucket key" in r["error"]
    assert d._records == {} and d.tenants.get("engine-1").rejected == 1


def test_a_measuring_daemon_prices_a_serve_kind_submit_in_its_own_process(
        tmp_path):
    """Over subprocess lanes that measure on the CPU, a serve-kind request
    never reaches a lane: the pool prices its tests in the daemon's
    process, on the cost model, as the JAX daemon prices them; the repeat
    is a store hit.  Kernel requests still go to the lane."""
    pool = PORT.fleet.SubprocessWorkerPool(devices=["cpu"])
    d = PORT.service.TuningDaemon(
        pool, PORT.service.ShardedConfigStore(str(tmp_path / "c"),
                                              n_shards=2),
        default_trial_budget=6)
    d.start()
    try:
        with PORT.client.ServiceClient(d.address, timeout=30) as c:
            r = c.submit_serve("engine-1", "h100_sxm", bucket="p2n2",
                               bucket_shape=[40, 12],
                               batch_sizes=[1, 2, 4, 8, 16],
                               max_seqs=[32, 64, 96, 128])
            res = c.result(r["request_id"], timeout=120)
            assert res["trials"] == 6 and res["config"]["MAX_SEQ"] >= 52
            again = c.submit_serve("engine-1", "h100_sxm", bucket="p2n2",
                                   bucket_shape=[40, 12],
                                   batch_sizes=[1, 2, 4, 8, 16],
                                   max_seqs=[32, 64, 96, 128])
            assert again["state"] == "done" and again["trials"] == 0
            st = c.stats()
        assert st["lanes"][0]["launches"] == {} or not any(
            st["lanes"][0]["launches"].values())
        priced = PORT.tuning.problem.make_problem(
            "serve", "p2n2", shape=(40, 12), batch_sizes=(1, 2, 4, 8, 16),
            max_seqs=(32, 64, 96, 128)).make_evaluator(
                PORT.service.daemon.hwspec.get("h100_sxm"))
        space = PORT.tuning.problem.make_problem(
            "serve", "p2n2", batch_sizes=(1, 2, 4, 8, 16),
            max_seqs=(32, 64, 96, 128)).space()
        assert res["runtime"] == priced(space.index_of(res["config"]),
                                        False)[0]
        assert d.store.provenance == "cpu"
    finally:
        _stop(d)


@pytest.mark.parametrize("spec", ["sharding:qwen2.5-3b/train_4k",
                                  "sharding:gemma-2b/prefill_32k"])
def test_a_problem_of_a_kind_not_ported_is_refused(spec):
    # every problem kind of the JAX package is ported now: a sharding
    # submit is accepted and priced (tests/test_torch_sharding_problem.py
    # holds its answer to the JAX daemon's)
    d = make_daemon(PORT)
    r = d.handle(PORT.P.validate_request({
        "op": "submit", "kind": "problem", "tenant": "t", "problem": spec,
        "hardware": HW}))
    assert r["ok"] and r["state"] == "queued", r
    assert list(d._records) == [r["request_id"]]


def test_a_jax_corpus_is_refused(tmp_path):
    root = str(tmp_path / "corpus")
    JAX.service.ShardedConfigStore(root, n_shards=2).put(
        "sp", "b", HW, config={"X": 1}, runtime=1.0, trials=1)
    with pytest.raises(ValueError, match="repro_torch.sharded_store"):
        PORT.service.ShardedConfigStore(root)
    port_root = str(tmp_path / "port")
    PORT.service.ShardedConfigStore(port_root, n_shards=2)
    with pytest.raises(ValueError):
        JAX.service.ShardedConfigStore(port_root)


def test_a_sharded_corpus_names_the_ports_format(tmp_path):
    import json

    root = tmp_path / "corpus"
    PORT.service.ShardedConfigStore(str(root), n_shards=3)
    meta = json.loads((root / "shards.json").read_text())
    assert meta == {"format": "repro_torch.sharded_store", "version": 1,
                    "shards": 3}


# =============================================================================
# Provenance: priced, CPU-measured and card-measured results never mix
# =============================================================================
def _cpu_pool():
    return PORT.fleet.ThreadWorkerPool(workers=1, devices=["cpu"])


def _priced_corpus(root):
    """A corpus and journal a priced daemon wrote, one result in them."""
    store = PORT.service.ShardedConfigStore(root, n_shards=2)
    journal = os.path.join(root, "journal.jsonl")
    d = make_daemon(PORT, store=store, journal=journal)
    r = submit_kernel(PORT, d, "a", kernel="matmul", input="128",
                      hw="h100_sxm")
    drive(d, lambda: d._records[r["request_id"]].state == "done")
    d.journal.close()
    assert len(store) == 1 and store.provenance is None
    return journal


def test_a_measuring_daemon_refuses_a_priced_corpus(tmp_path):
    root = str(tmp_path / "corpus")
    _priced_corpus(root)
    pool = _cpu_pool()
    try:
        with pytest.raises(ValueError, match="unstamped results"):
            PORT.service.TuningDaemon(
                pool, PORT.service.ShardedConfigStore(root))
    finally:
        pool.close()
    assert PORT.service.ShardedConfigStore(root).provenance is None


def test_a_measuring_daemon_refuses_a_priced_journal(tmp_path):
    journal = _priced_corpus(str(tmp_path / "priced"))
    pool = _cpu_pool()
    try:
        with pytest.raises(ValueError, match="priced on the cost model"):
            PORT.service.TuningDaemon(
                pool, PORT.service.ShardedConfigStore(
                    str(tmp_path / "fresh")), journal=journal)
    finally:
        pool.close()


def test_a_measuring_daemon_stamps_its_corpus_and_journal(tmp_path):
    import json

    root = tmp_path / "corpus"
    journal = str(root / "journal.jsonl")
    pool = _cpu_pool()
    try:
        d = PORT.service.TuningDaemon(
            pool, PORT.service.ShardedConfigStore(str(root), n_shards=2),
            journal=journal)
        assert d.provenance == "cpu"
        d.journal.close()
        meta = json.loads((root / "shards.json").read_text())
        assert meta["provenance"] == "cpu"
        starts = [ev for ev in PORT.journal.replay(journal)[0]
                  if ev["ev"] == "daemon_start"]
        assert [ev["provenance"] for ev in starts] == ["cpu"]
        # the same kind of daemon takes them again, with --recover too
        d = PORT.service.TuningDaemon(
            pool, PORT.service.ShardedConfigStore(str(root)),
            journal=journal, recover=True)
        d.journal.close()
    finally:
        pool.close()
    # a priced daemon takes neither
    with pytest.raises(ValueError, match="measured on the CPU"):
        make_daemon(PORT, store=PORT.service.ShardedConfigStore(str(root)))
    with pytest.raises(ValueError, match="measured on the CPU"):
        make_daemon(PORT, journal=journal)


def test_a_priced_daemon_stamps_nothing(tmp_path):
    root = str(tmp_path / "corpus")
    journal = _priced_corpus(root)
    starts = [ev for ev in PORT.journal.replay(journal)[0]
              if ev["ev"] == "daemon_start"]
    assert starts and all("provenance" not in ev for ev in starts)
    make_daemon(PORT, store=PORT.service.ShardedConfigStore(root),
                journal=journal).journal.close()


def test_a_card_daemon_refuses_a_cpu_corpus(tmp_path):
    """A corpus the CPU's plain versions filled, stamped ``cpu``, is not a
    card daemon's, though both key their results ``h100_sxm``."""
    from repro_torch.core import hwspec
    from repro_torch.service.daemon import _claim_store, _provenance

    store = PORT.tuning.ConfigStore(str(tmp_path / "store.json"))
    store.set_provenance("cpu")
    store.put("gemm", "128", "h100_sxm", config={"X": 1}, runtime=1.0,
              trials=1)
    assert _provenance([("cuda:0", hwspec.H100_SXM)]) == "card"
    with pytest.raises(ValueError, match="measured on the CPU"):
        _claim_store(PORT.tuning.ConfigStore(store.path), "card")


def test_a_daemon_measures_on_cards_or_on_the_cpu_not_both():
    from repro_torch.core import hwspec
    from repro_torch.service.daemon import _provenance

    with pytest.raises(ValueError, match="not on both"):
        _provenance([("cpu", hwspec.H100_SXM), ("cuda:0", hwspec.H100_SXM)])
    assert _provenance([]) == "priced"


def test_a_store_file_keeps_its_stamp_and_merges_only_its_own(tmp_path):
    path = str(tmp_path / "store.json")
    a = PORT.tuning.ConfigStore(path)
    a.set_provenance("card")
    a.put("gemm", "128", "h100_sxm", config={"X": 1}, runtime=1.0, trials=1)
    b = PORT.tuning.ConfigStore(path)
    assert b.provenance == "card" and len(b) == 1
    # an unstamped writer's results never land in the stamped file
    c = PORT.tuning.ConfigStore()
    c.put("gemm", "2048", "h100_sxm", config={"X": 2}, runtime=2.0,
          trials=1)
    with pytest.raises(ValueError, match="unstamped results into one of "
                       "card"):
        b._merge_from(c.to_dict())
    with pytest.raises(ValueError, match="card results into one of "
                       "unstamped"):
        c.save(path)
    # an empty unstamped store adopts the stamp of what it merges
    e = PORT.tuning.ConfigStore()
    e._merge_from(a.to_dict())
    assert e.provenance == "card" and len(e) == 1
    assert "provenance" not in PORT.tuning.ConfigStore().to_dict()


def test_a_measuring_daemon_reads_its_cards_off_the_lanes(monkeypatch):
    """A subprocess lane reports its card's name; the daemon's specs and
    jobs come from it, and nothing in the daemon's process asks CUDA."""
    from repro_torch.core import hwspec
    from repro_torch.fleet import job_from_registry
    from repro_torch.service.daemon import _pool_cards

    def no_cuda(index=0):
        raise AssertionError("the daemon process asked CUDA for a card")

    monkeypatch.setattr(hwspec, "detect", no_cuda)

    class Lanes:
        devices = ["cuda:0", None, "cuda:1"]

        @staticmethod
        def lane_info():
            return [{"device_name": "NVIDIA H100 80GB HBM3"},
                    {"device_name": None},
                    {"device_name": "NVIDIA H100 PCIe"}]

    cards = _pool_cards(Lanes())
    assert [(dev, spec.name) for dev, spec in cards] == \
        [("cuda:0", "h100_sxm"), ("cuda:1", "h100_pcie")]
    job = job_from_registry("matmul", "128", cards[1][1], device="cuda:1",
                            card=cards[1][1])
    assert job.measured and job.hardware_key == "h100_pcie"
    with pytest.raises(ValueError, match="not 'h100_sxm'"):
        job_from_registry("matmul", "128", "h100_sxm", device="cuda:1",
                          card=cards[1][1])


def test_cli_refuses_a_store_of_another_provenance(tmp_path):
    from repro_torch.launch.daemon import main

    root = tmp_path / "corpus"
    PORT.service.ShardedConfigStore(str(root)).set_provenance("cpu")
    with pytest.raises(SystemExit, match="cannot start the daemon: .* "
                       "measured on the CPU"):
        main(["--backend", "virtual", "--store-dir", str(root),
              "--port", "0"])


# =============================================================================
# The daemon CLI
# =============================================================================
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _spawn_cli(args, cwd, timeout=120):
    """The daemon CLI in a subprocess; returns it and its address once it
    printed the line naming its port (lines before it are kept)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.daemon", *args],
        cwd=cwd, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    found = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "tuning service on" in line and not found:
                found.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.time() + timeout
    while not found and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    if not found:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("daemon did not come up: " + "".join(lines))
    addr = found[0].split("tuning service on ")[1].split()[0]
    host, port = addr.rsplit(":", 1)
    return proc, (host, int(port)), lines, reader


def _finish_cli(proc, reader, client):
    try:
        client.shutdown(drain=True)
        assert proc.wait(timeout=120) == 0
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_prices_on_the_virtual_backend(tmp_path):
    proc, addr, lines, reader = _spawn_cli(
        ["--backend", "virtual", "--store-dir", str(tmp_path / "corpus"),
         "--port", "0", "--budget", "4"], tmp_path)
    c = PORT.client.ServiceClient(addr, timeout=30)
    try:
        r = c.submit_kernel("a", "matmul", "h100_sxm", input="2048")
        res = c.result(r["request_id"], timeout=120)
        assert res["trials"] == 4 and res["source"] == "tuned"
        assert "lanes" not in c.stats()
    finally:
        _finish_cli(proc, reader, c)
    out = "".join(lines)
    assert "priced on the cost model" in out and "[daemon] drained" in out
    assert (tmp_path / "corpus" / "journal.jsonl").exists()


def test_cli_measures_on_the_cpu_when_asked(tmp_path):
    proc, addr, lines, reader = _spawn_cli(
        ["--devices", "cpu", "--store-dir", str(tmp_path / "corpus"),
         "--port", "0", "--budget", "2"], tmp_path)
    c = PORT.client.ServiceClient(addr, timeout=30)
    try:
        r = c.submit_kernel("a", "matmul", "h100_sxm", input="128")
        res = c.result(r["request_id"], timeout=240)
        assert res["trials"] == 2 and np.isfinite(res["runtime"])
        with pytest.raises(PORT.client.ServiceError, match="no card of"):
            c.submit_kernel("a", "matmul", "h100_pcie", input="128")
        lanes = c.stats()["lanes"]
        assert lanes[0]["device"] == "cpu"
        assert lanes[0]["launches"]["matmul"] == 0   # plain versions
    finally:
        _finish_cli(proc, reader, c)
    out = "".join(lines)
    assert "[daemon] lane 0 on cpu (cpu)" in out
    assert "measured on cpu" in out and "launches {" in out


def test_cli_refuses_to_start_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import daemon as cli
    from repro_torch.launch import fleet

    monkeypatch.setattr(fleet, "visible_cards", lambda: [])
    with pytest.raises(SystemExit, match="--devices cpu"):
        cli.main(["--store-dir", str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="--devices is for"):
        cli.main(["--backend", "virtual", "--devices", "cpu",
                  "--store-dir", str(tmp_path / "c")])


def test_cli_rejects_an_unknown_fsync_mode():
    from repro_torch.launch.daemon import main

    with pytest.raises(SystemExit) as ei:
        main(["--backend", "virtual", "--fsync", "sometimes", "--port", "0"])
    assert ei.value.code == 2
    assert "sometimes" not in PORT.journal.MODES


def test_the_ports_jobs_are_keyed_as_the_jax_packages(tmp_path):
    """Each kernel's store key, priced on the same hardware name, is the
    same in both daemons (the registry's spaces and buckets agree)."""
    from repro.kernels.registry import BENCHMARKS as JB
    from repro_torch.kernels.registry import BENCHMARKS as PB

    keys = []
    for S in (JAX, PORT):
        d = make_daemon(S, tenants=S.tenants.TenantManager(
            max_queued_per_tenant=1000))
        bench = PB if S.port else JB
        keys.append([d._records[submit_kernel(
            S, d, "t", kernel=k, input=i)["request_id"]].key
            for k in sorted(bench) for i in sorted(bench[k].inputs)])
    assert keys[0] == keys[1]


def test_dataclass_fields_of_the_request_record_are_the_jax_ones():
    from repro.service.daemon import RequestRecord as J
    from repro_torch.service.daemon import RequestRecord as P

    assert [f.name for f in dataclasses.fields(P)] == \
        [f.name for f in dataclasses.fields(J)]
