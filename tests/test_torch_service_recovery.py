"""Crash safety of the port's tuning service against the JAX package's:
journal, recovery, self-healing clients, store integrity.

All 18 cases of ``tests/test_service_recovery.py`` and the journal and
daemon cases of ``tests/test_throughput.py`` run on BOTH packages
(``both``): each side makes the JAX test's assertions and returns a
transcript — every response, the tenant snapshots, the store's contents,
the journal's events and replay stats with wall-clock fields left out —
and the two transcripts must be equal.  Where threads race (the group
commit under 16 writers, a socket storm) the transcript holds what the
race cannot change: no ack before durability, every record on disk.  The
SIGKILL-and-recover drill runs against ``python -m
repro_torch.launch.daemon --backend virtual``.

Beside parity, the port's store reads version 3 only: a version-2 file
and a 3-part key are refused.  Every socket, join and subprocess has a
timeout of its own.
"""
import io
import json
import os
import signal
import socket as socketlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest
import torch  # noqa: F401

from _torch_service_sides import (HW, JAX, PORT, both, drive, final_state,
                                  journal_events, make_daemon, store_state,
                                  submit_kernel, tpu_names)

pytestmark = pytest.mark.usefixtures("tpu_names")
assert tpu_names
ROOT = Path(__file__).resolve().parents[1]


def _submit(S, d, tenant, idem=None, budget_s=None, kernel="matmul",
            input="2048"):
    return submit_kernel(S, d, tenant, kernel=kernel, input=input,
                         idempotency_key=idem, tenant_budget_s=budget_s)


def _fleet_trials(d):
    return sum(js.account.steps for js in d.tuner._states)


def _sharded(S, root, name="corpus"):
    return S.service.ShardedConfigStore(os.path.join(root, name),
                                        n_shards=2)


# =============================================================================
# Journal: append, replay, damage tolerance
# =============================================================================
def _journal_roundtrip(S, root):
    path = os.path.join(root, "j.jsonl")
    with S.journal.RequestJournal(path) as j:
        j.append(S.journal.EV_SUBMIT, rid="r000001", key="a|b|c")
        j.append("done", rid="r000001", result={"runtime": 1.5})
    events, stats = S.journal.replay(path)
    assert [e["ev"] for e in events] == ["submit", "done"]
    assert stats.events == 2 and stats.corrupt == 0 and stats.torn == 0
    assert stats.last_seq == 2
    with S.journal.RequestJournal(path) as j2:
        j2.replay()
        rec = j2.append("cancelled", rid="r000002")
    assert rec["seq"] == 3
    return [rec, journal_events(S, path)]


def _journal_replay_forgives_torn_tail_and_corrupt_interior(S, root):
    path = os.path.join(root, "j.jsonl")
    with S.journal.RequestJournal(path) as j:
        for rid in ("r1", "r2", "r3"):
            j.append(S.journal.EV_SUBMIT, rid=rid)
    lines = open(path, "rb").read().splitlines(keepends=True)
    lines[1] = lines[1].replace(b'"rid":"r2"', b'"rid":"rX"')
    lines.append(b'{"seq": 4, "ev": "done", "tru')
    with open(path, "wb") as f:
        f.writelines(lines)
    events, stats = S.journal.replay(path)
    assert [e["rid"] for e in events] == ["r1", "r3"]
    assert stats.corrupt == 1 and stats.torn == 1
    return journal_events(S, path)


# =============================================================================
# Daemon recovery (in-process crash drills: no sockets, no loop thread)
# =============================================================================
def _recover_resumes_interrupted_job_with_remaining_budget(S, root):
    jpath = os.path.join(root, "journal.jsonl")
    d = make_daemon(S, _sharded(S, root), journal=jpath)
    rid = _submit(S, d, "a", idem="k1", budget_s=60.0)["request_id"]
    drive(d, lambda: d._records[rid].trials >= 2)
    before = _fleet_trials(d)
    assert 0 < before < 6
    spent_before = d._records[rid].spent_s
    d.journal.close()

    d2 = make_daemon(S, _sharded(S, root), journal=jpath, recover=True)
    assert d2.recovery["resubmitted"] == 1
    rec = d2._records[rid]
    assert rec.recovered and rec.resumed_trials == before
    drive(d2, lambda: d2._records[rid].state == "done")
    res = d2.handle({"op": "result", "request_id": rid})
    assert res["ok"] and res["trials"] == 6
    assert before + _fleet_trials(d2) == 6
    ts = d2.tenants.snapshot()["a"]
    assert ts["budget_s"] == 60.0
    assert ts["spent_s"] >= round(spent_before, 6) > 0
    out = [before, d2.recovery, res, final_state(S, d2)]
    d2.journal.close()
    return out + [journal_events(S, jpath)]


def _recover_restores_done_requests_and_tenant_spend(S, root):
    jpath = os.path.join(root, "journal.jsonl")
    d = make_daemon(S, _sharded(S, root), journal=jpath)
    rid = _submit(S, d, "a", idem="k1", budget_s=60.0)["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    want = d.handle({"op": "result", "request_id": rid})
    spent = d.tenants.snapshot()["a"]["spent_s"]
    d.journal.close()

    d2 = make_daemon(S, _sharded(S, root), journal=jpath, recover=True)
    assert d2.recovery["restored_done"] == 1
    got = d2.handle({"op": "result", "request_id": rid})
    assert got["config"] == want["config"]
    assert got["trials"] == want["trials"] == 6
    assert d2.tenants.snapshot()["a"]["spent_s"] == pytest.approx(spent)
    again = _submit(S, d2, "a", idem="k1")
    assert again["request_id"] == rid and again["deduped"]
    fresh = _submit(S, d2, "b")
    assert fresh["state"] == "done" and fresh["trials"] == 0
    assert fresh["source"] == "store"
    out = [want, d2.recovery, got, again, fresh, final_state(S, d2)]
    d2.journal.close()
    return out + [journal_events(S, jpath)]


def _recover_rebuilds_store_from_journal_after_shard_loss(S, root):
    jpath = os.path.join(root, "journal.jsonl")
    corpus = os.path.join(root, "corpus")
    d = make_daemon(S, _sharded(S, root), journal=jpath)
    rid = _submit(S, d, "a")["request_id"]
    drive(d, lambda: d._records[rid].state == "done")
    key = d._records[rid].key
    d.journal.close()
    for f in os.listdir(corpus):
        if f.startswith("shard-"):
            os.unlink(os.path.join(corpus, f))

    d2 = make_daemon(S, _sharded(S, root), journal=jpath, recover=True)
    assert d2.recovery["repaired_entries"] == 1
    kind, space, bucket, hw = key.split("|")
    entry = d2.store.get(space, bucket, hw, kind=kind)
    assert entry is not None and entry.meta.get("recovered")
    r = _submit(S, d2, "b")
    assert r["state"] == "done" and r["trials"] == 0
    out = [d2.recovery, r, final_state(S, d2)]
    d2.journal.close()
    return out + [journal_events(S, jpath)]


def _idempotent_resubmit_dedupes_in_flight(S, root):
    jpath = os.path.join(root, "j.jsonl")
    d = make_daemon(S, _sharded(S, root, "c"), journal=jpath)
    r1 = _submit(S, d, "a", idem="once")
    r2 = _submit(S, d, "a", idem="once")
    assert r2["request_id"] == r1["request_id"] and r2["deduped"]
    assert r2["state"] == "queued"
    r3 = _submit(S, d, "b", idem="once")
    assert r3["request_id"] != r1["request_id"]
    assert r3.get("coalesced") == r1["request_id"]
    assert d.tenants.snapshot()["a"]["submitted"] == 1
    out = [r1, r2, r3, final_state(S, d)]
    d.journal.close()
    return out + [journal_events(S, jpath)]


def _recover_requires_journal(S, root):
    with pytest.raises(ValueError) as ei:
        S.service.TuningDaemon(S.fleet.VirtualWorkerPool(workers=2),
                               S.tuning.ConfigStore(), recover=True)
    return str(ei.value)


def _health_op_in_process(S, root):
    d = make_daemon(S, _sharded(S, root, "c"),
                    journal=os.path.join(root, "j.jsonl"))
    h = d.handle({"op": "health"})
    assert h["ok"] and h["live"] and h["ready"]
    assert h["journal_enabled"] and h["store_writable"]
    d.shutdown(drain=False)
    h2 = d.handle({"op": "health"})
    assert h2["draining"] and not h2["ready"]
    d.journal.close()
    return [h, h2]


# =============================================================================
# Store integrity: quarantine instead of crash
# =============================================================================
def _config_store_quarantines_truncated_file(S, root):
    path = os.path.join(root, "store.json")
    s = S.tuning.ConfigStore(path)
    s.put("sp", "128", HW, config={"BM": 32}, runtime=1.0, trials=4)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    s2 = S.tuning.ConfigStore(path)
    assert len(s2) == 0 and s2.quarantined
    assert os.path.exists(path + ".corrupt")
    s2.put("sp", "128", HW, config={"BM": 64}, runtime=2.0, trials=1)
    again = S.tuning.ConfigStore(path)
    assert again.get("sp", "128", HW) is not None
    return [s2.quarantined, store_state(S, again)]


def _config_store_quarantines_checksum_mismatch(S, root):
    path = os.path.join(root, "store.json")
    s = S.tuning.ConfigStore(path)
    s.put("sp", "128", HW, config={"BM": 32}, runtime=1.0, trials=4)
    d = json.load(open(path))
    key = next(iter(d["entries"]))
    d["entries"][key]["runtime"] = 0.001
    json.dump(d, open(path, "w"))
    s2 = S.tuning.ConfigStore(path)
    assert len(s2) == 0 and s2.quarantined
    return s2.quarantined


def _sharded_store_quarantines_bad_shard_and_meta(S, root):
    corpus = os.path.join(root, "corpus")
    s = S.service.ShardedConfigStore(corpus, n_shards=2)
    s.put("sp", "128", HW, config={"BM": 32}, runtime=1.0, trials=4)
    for f in os.listdir(corpus):
        with open(os.path.join(corpus, f), "w") as fh:
            fh.write('{"torn')
    s2 = S.service.ShardedConfigStore(corpus, n_shards=2)
    assert s2.n_shards == 2 and len(s2) == 0
    assert os.path.exists(os.path.join(corpus, "shards.json"))
    s2.put("sp", "128", HW, config={"BM": 64}, runtime=2.0, trials=1)
    again = S.service.ShardedConfigStore(corpus)
    assert again.get("sp", "128", HW) is not None
    return [sorted(os.listdir(corpus)), store_state(S, again)]


# =============================================================================
# Client self-healing: sent-vs-unsent, idempotent-only retry
# =============================================================================
def _failing_client(S, failures):
    c = S.client.ServiceClient(("127.0.0.1", 1), retries=3, backoff=0.001)
    calls = {"n": 0}

    def fake(obj):
        i = calls["n"]
        calls["n"] += 1
        if i < len(failures):
            raise S.client._TransportFailure(failures[i], "scripted failure")
        return {"ok": True, "echo": obj}

    c._round_trip = fake
    return c, calls


def _client_retries_unsent_requests(S, root):
    c, calls = _failing_client(S, [False, False])
    resp = c.call({"op": "submit"})
    assert resp["ok"] and calls["n"] == 3
    return [resp, calls]


def _client_refuses_to_retry_sent_non_idempotent(S, root):
    c, calls = _failing_client(S, [True])
    with pytest.raises(S.client.ServiceUnavailable) as ei:
        c.call({"op": "submit"})
    assert "may have been received" in str(ei.value)
    assert calls["n"] == 1
    return [str(ei.value), ei.value.code, calls]


def _client_retries_sent_idempotent(S, root):
    c, calls = _failing_client(S, [True, True])
    resp = c.call({"op": "status"}, idempotent=True)
    assert resp["ok"] and calls["n"] == 3
    return [resp, calls]


def _client_deadline_bounds_retries(S, root):
    c, _ = _failing_client(S, [False] * 10)
    c.retries = 100
    c.backoff = 0.05
    t0 = time.monotonic()
    with pytest.raises(S.client.ServiceUnavailable) as ei:
        c.call({"op": "ping"}, idempotent=True, deadline_s=0.2)
    assert time.monotonic() - t0 < 2.0
    return ei.value.code


# =============================================================================
# Protocol: oversize line bound
# =============================================================================
def _protocol_read_line_bound(S, root):
    big = b"x" * (S.P.MAX_LINE_BYTES + 10) + b"\n"
    with pytest.raises(S.P.ProtocolError) as ei:
        S.P.read_line(io.BytesIO(big))
    small = S.P.read_line(io.BytesIO(b"small\n"))
    assert small == b"small\n"
    assert S.P.read_line(io.BytesIO(b"")) is None
    return [str(ei.value), small]


def _daemon_socket_rejects_oversize_line(S, root):
    d = S.service.TuningDaemon(S.fleet.VirtualWorkerPool(workers=2),
                               _sharded(S, root, "c"),
                               default_trial_budget=4)
    d.start()
    try:
        with socketlib.create_connection(d.address, timeout=10) as s:
            s.sendall(b'{"op": "ping", "pad": "'
                      + b"x" * (S.P.MAX_LINE_BYTES + 100) + b'"}\n')
            resp = S.P.decode(s.makefile("rb").readline())
            assert not resp["ok"] and resp["code"] == S.P.E_BAD_REQUEST
            s.settimeout(10)
            assert s.recv(1) == b""
        return resp
    finally:
        d.shutdown(drain=False)
        assert d.wait(timeout=60)


# =============================================================================
# test_throughput.py: journal modes, group commit, acks after durability
# =============================================================================
def _journal_mode_validation(S, root):
    with pytest.raises(ValueError) as ei:
        S.journal.RequestJournal(os.path.join(root, "j.jsonl"),
                                 mode="sometimes")
    return str(ei.value)


def _journal_fsync_flag_backcompat(S, root):
    J = S.journal
    out = []
    for name, kw in (("a", {"fsync": True}), ("b", {"fsync": False}),
                     ("c", {"mode": J.MODE_BATCH})):
        with J.RequestJournal(os.path.join(root, name), **kw) as j:
            out.append((j.mode, j.fsync))
    assert out == [(J.MODE_ALWAYS, True), (J.MODE_OFF, False),
                   (J.MODE_BATCH, True)]
    return out


def _journal_stats_expose_mode_and_commits(S, root):
    J = S.journal
    with J.RequestJournal(os.path.join(root, "j.jsonl"),
                          mode=J.MODE_BATCH) as j:
        j.append(J.EV_SUBMIT, rid="r1", key="k")
        st = j.stats()
        assert st["mode"] == J.MODE_BATCH and st["commits"] >= 1
        assert st["pending"] == 0 and st["max_batch"] >= 1
    return [st["mode"], st["pending"], st["records"], st["bytes"] > 0]


def _batch_append_returns_only_after_durable(S, root):
    J = S.journal
    path = os.path.join(root, "j.jsonl")
    violations = []
    with J.RequestJournal(path, mode=J.MODE_BATCH) as j:

        def writer(t):
            for n in range(25):
                rec = j.append(J.EV_SUBMIT, rid=f"t{t}n{n}", key="k")
                if j.durable_upto() < rec["seq"]:
                    violations.append((t, n, rec["seq"]))

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert not violations and j.appends == 16 * 25
        assert j.stats()["commits"] < j.appends
    events, stats = J.replay(path)
    assert stats.events == 16 * 25 and stats.corrupt == 0
    return [violations, stats.to_dict(),
            sorted(e["rid"] for e in events)]


def _batch_ticket_wait_durable(S, root):
    J = S.journal
    with J.RequestJournal(os.path.join(root, "j.jsonl"),
                          mode=J.MODE_BATCH) as j:
        rec = j.append(J.EV_SUBMIT, wait=False, rid="r1", key="k")
        gate = j.ticket()
        assert gate >= rec["seq"]
        j.wait_durable(gate)
        assert j.durable_upto() >= gate
    return [rec["seq"], gate]


def _kick_ends_quiesce_early(S, root):
    J = S.journal
    j = J.RequestJournal(os.path.join(root, "j.jsonl"), mode=J.MODE_BATCH,
                         batch_window_s=0.3, batch_max_delay_s=2.0)
    try:
        rec = j.append(J.EV_SUBMIT, wait=False, rid="r1", key="k")
        t0 = time.monotonic()
        j.kick()
        j.wait_durable(rec["seq"])
        assert time.monotonic() - t0 < 0.25
    finally:
        j.close()
    return rec["seq"]


def _batch_mode_survives_closed_without_loss(S, root):
    J = S.journal
    path = os.path.join(root, "j.jsonl")
    with J.RequestJournal(path, mode=J.MODE_BATCH) as j:
        for n in range(10):
            j.append(J.EV_SUBMIT, wait=False, rid=f"r{n}", key="k")
    events, stats = J.replay(path)
    assert stats.events == 10 and stats.corrupt == 0 and stats.torn == 0
    return journal_events(S, path)


def _storm_daemon(S, root, mode):
    store = _sharded(S, root)
    job = S.fleet.job_from_registry("matmul", "2048", HW)
    store.put(job.space.name, job.bucket, job.hardware_key,
              config=dict(job.space[0]), runtime=1.0, trials=8)
    store.save()
    jpath = os.path.join(root, "journal.jsonl")
    d = S.service.TuningDaemon(
        S.fleet.VirtualWorkerPool(workers=2), store,
        default_trial_budget=4,
        journal=S.journal.RequestJournal(jpath, mode=mode))
    d.start()
    return d, jpath


def _daemon_acked_submits_are_on_disk(S, root, mode):
    d, jpath = _storm_daemon(S, root, mode)
    acked, errors = [], []

    def client(t):
        try:
            with socketlib.create_connection(d.address, timeout=30) as s:
                f = s.makefile("rb")
                for _ in range(10):
                    s.sendall(S.P.encode(dict(
                        op="submit", kind="kernel", tenant=f"t{t}",
                        kernel="matmul", input="2048", hardware=HW,
                        budget=4, seed=7)))
                    r = json.loads(f.readline())
                    assert r["ok"] and r["state"] == "done"
                    acked.append(r["request_id"])
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    try:
        assert not errors and len(acked) == 60
        events, stats = S.journal.replay(jpath)
        assert stats.corrupt == 0
        on_disk = {}
        for e in events:
            if e.get("rid"):
                on_disk.setdefault(e["rid"], set()).add(e["ev"])
        for rid in acked:
            assert {"submit", "done"} <= on_disk.get(rid, set()), rid
        return [sorted(acked), d.tenants.snapshot()]
    finally:
        d.shutdown(drain=False)
        assert d.wait(timeout=60)


def _daemon_acked_submits_are_on_disk_always(S, root):
    return _daemon_acked_submits_are_on_disk(S, root, S.journal.MODE_ALWAYS)


def _daemon_acked_submits_are_on_disk_batch(S, root):
    return _daemon_acked_submits_are_on_disk(S, root, S.journal.MODE_BATCH)


def _daemon_health_reports_journal_mode(S, root):
    d, _ = _storm_daemon(S, root, S.journal.MODE_BATCH)
    try:
        with socketlib.create_connection(d.address, timeout=30) as s:
            f = s.makefile("rb")
            s.sendall(S.P.encode({"op": "stats"}))
            r = json.loads(f.readline())
        assert r["ok"] and r["journal"]["mode"] == S.journal.MODE_BATCH
        assert "commits" in r["journal"]
        assert r["store_saves"]["saves"] >= 0
        return [r["journal"]["mode"], r["journal"]["path"],
                r["tenants"], r["store_entries"]]
    finally:
        d.shutdown(drain=False)
        assert d.wait(timeout=60)


def _daemon_accepts_journal_instance(S, root):
    jpath = os.path.join(root, "j.jsonl")
    d = make_daemon(S, default_trial_budget=4, workers=2,
                    journal=S.journal.RequestJournal(
                        jpath, mode=S.journal.MODE_OFF))
    r = d.handle(S.P.validate_request(dict(
        op="submit", kind="kernel", tenant="t", kernel="matmul",
        input="2048", hardware=HW, budget=4, seed=7, wait=False)))
    assert r["ok"]
    d.journal.close()
    events = journal_events(S, jpath)
    assert any(e["ev"] == "submit" for e in events["events"])
    return [r, events]


CASES = {f.__name__[1:]: f for f in (
    _journal_roundtrip,
    _journal_replay_forgives_torn_tail_and_corrupt_interior,
    _recover_resumes_interrupted_job_with_remaining_budget,
    _recover_restores_done_requests_and_tenant_spend,
    _recover_rebuilds_store_from_journal_after_shard_loss,
    _idempotent_resubmit_dedupes_in_flight, _recover_requires_journal,
    _health_op_in_process,
    _config_store_quarantines_truncated_file,
    _config_store_quarantines_checksum_mismatch,
    _sharded_store_quarantines_bad_shard_and_meta,
    _client_retries_unsent_requests,
    _client_refuses_to_retry_sent_non_idempotent,
    _client_retries_sent_idempotent, _client_deadline_bounds_retries,
    _protocol_read_line_bound, _daemon_socket_rejects_oversize_line,
    _journal_mode_validation, _journal_fsync_flag_backcompat,
    _journal_stats_expose_mode_and_commits,
    _batch_append_returns_only_after_durable, _batch_ticket_wait_durable,
    _kick_ends_quiesce_early, _batch_mode_survives_closed_without_loss,
    _daemon_acked_submits_are_on_disk_always,
    _daemon_acked_submits_are_on_disk_batch,
    _daemon_health_reports_journal_mode, _daemon_accepts_journal_instance)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_recovers_as_the_jax_service_does(case, tmp_path):
    jax_side, port_side = both(CASES[case], tmp_path)
    assert port_side == jax_side


# =============================================================================
# Full SIGKILL drill: the port's daemon CLI, kill -9, restart --recover
# =============================================================================
def _free_port():
    s = socketlib.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_daemon(tmp_path, port, recover=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.daemon",
           "--backend", "virtual", "--workers", "4",
           "--store-dir", str(tmp_path / "corpus"), "--shards", "2",
           "--journal", str(tmp_path / "journal.jsonl"),
           "--port", str(port), "--budget", "6"]
    if recover:
        cmd.append("--recover")
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    up = threading.Event()
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "tuning service on" in line:
                up.set()

    threading.Thread(target=read, daemon=True).start()
    if not up.wait(timeout=60):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"daemon did not come up: {''.join(lines)}")
    return proc


def test_sigkill_recover_end_to_end(tmp_path):
    C = PORT.client
    port = _free_port()
    proc = _spawn_daemon(tmp_path, port)
    try:
        c = C.ServiceClient(("127.0.0.1", port), timeout=30)
        c.wait_ready(timeout=30)
        r = c.submit_kernel("a", "matmul", "h100_sxm", input="2048",
                            budget=40, tenant_budget_s=120.0,
                            idempotency_key="boom")
        rid = r["request_id"]
        deadline = time.time() + 60
        while time.time() < deadline:
            if c.status(rid)["trials"] >= 2:
                break
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        with pytest.raises(C.ServiceError):
            C.ServiceClient(("127.0.0.1", port), timeout=5,
                            retries=1).ping()

        proc = _spawn_daemon(tmp_path, port, recover=True)
        c.wait_ready(timeout=30)
        res = c.result(rid, timeout=120)
        assert res["state"] == "done" and res["trials"] == 40
        assert c.status(rid)["recovered"]
        again = c.submit_kernel("a", "matmul", "h100_sxm", input="2048",
                                budget=40, idempotency_key="boom")
        assert again["request_id"] == rid and again.get("deduped")
        assert c.stats()["tenants"]["a"]["spent_s"] > 0
        c.shutdown(drain=True)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# =============================================================================
# The port's store reads version 3 only
# =============================================================================
def _written_store(tmp_path):
    path = str(tmp_path / "store.json")
    PORT.tuning.ConfigStore(path).put("gemm", "128", "h100_sxm",
                                      config={"BM": 32}, runtime=1.0,
                                      trials=4)
    return path


def test_the_store_refuses_a_version_2_file(tmp_path):
    from repro_torch.tuning import store as S

    path = _written_store(tmp_path)
    d = json.load(open(path))
    assert d["version"] == 3 and S.READABLE_VERSIONS == (3,)
    d["version"] = 2
    json.dump(d, open(path, "w"))
    with pytest.raises(ValueError, match="unsupported .* version 2"):
        PORT.tuning.ConfigStore(path)
    with pytest.raises(ValueError, match="refusing to merge"):
        PORT.tuning.ConfigStore()._merge_from(d)


def test_the_store_refuses_a_three_part_key(tmp_path):
    from repro_torch.tuning import store as S

    with pytest.raises(ValueError, match="malformed store key"):
        S.split_key("gemm|128|h100_sxm")
    assert S.split_key("kernel|gemm|128|h100_sxm") == \
        ("kernel", "gemm", "128", "h100_sxm")
    path = _written_store(tmp_path)
    d = json.load(open(path))
    d["entries"] = {k.partition("|")[2]: v for k, v in d["entries"].items()}
    d["crc"] = S.content_crc(d["entries"], d["models"])
    json.dump(d, open(path, "w"))
    with pytest.raises(ValueError, match="malformed store key"):
        PORT.tuning.ConfigStore(path)
    assert not hasattr(PORT.tuning, "upgrade_key")
    assert not hasattr(S, "upgrade_key")
