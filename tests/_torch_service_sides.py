"""What the service parity tests share: the two packages' service stacks
side by side, and the comparisons that hold them to each other.

A scenario ``scenario(S, root, ...)`` runs one case of the JAX package's
service tests on side ``S`` (its daemon, fleet, store, journal and
client), makes that test's assertions, and returns a transcript: every
response it saw, the tenant snapshots, the store's contents and the
journal's events.  ``both`` runs it on the JAX side and on the port's,
each in a directory of its own, and the test compares the transcripts.
The JAX tests name TPU hardware over the wire (``tpu_v4``, ``tpu_v5e``);
the ``tpu_names`` fixture registers those specs in the port under the
same names, converted field by field (``port_spec``), so both daemons key
their stores alike and price on the same numbers.  Wall-clock fields
(``WALL``) are left out, and each side's directory reads ``<root>``.
"""
import dataclasses
import os
import types

import pytest

import repro.fleet as jfleet
import repro.service as jservice
import repro.service.client as jclient
import repro.service.journal as jjournal
import repro.service.protocol as jP
import repro.service.tenants as jtenants
import repro.tuning as jtuning
import repro_torch.fleet as pfleet
import repro_torch.service as pservice
import repro_torch.service.client as pclient
import repro_torch.service.journal as pjournal
import repro_torch.service.protocol as pP
import repro_torch.service.tenants as ptenants
import repro_torch.tuning as ptuning
from repro.core import hwspec as jhw
from repro_torch.core import hwspec as phw
from repro_torch.tuning import from_jax_artifact
from test_torch_space_costmodel import port_spec

HW = "tpu_v4"


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's service stack."""

    name: str
    service: types.ModuleType
    P: types.ModuleType
    journal: types.ModuleType
    tenants: types.ModuleType
    client: types.ModuleType
    fleet: types.ModuleType
    tuning: types.ModuleType
    daemon_cli: str
    port: bool


JAX = Side("jax", jservice, jP, jjournal, jtenants, jclient, jfleet, jtuning,
           "repro.launch.daemon", False)
PORT = Side("port", pservice, pP, pjournal, ptenants, pclient, pfleet,
            ptuning, "repro_torch.launch.daemon", True)


@pytest.fixture
def tpu_names(monkeypatch):
    """The JAX package's TPU specs, converted, registered in the port under
    their own names (and the name cache emptied around it)."""
    specs = dict(phw.SPECS)
    specs.update({n: port_spec(s) for n, s in jhw.SPECS.items()})
    monkeypatch.setattr(phw, "SPECS", specs)
    monkeypatch.setattr(phw, "_NORMALIZE_CACHE", {})


def both(scenario, root, *args, **kwargs):
    """Run ``scenario`` on each side, in ``root/jax`` and ``root/port``."""
    out = []
    for S in (JAX, PORT):
        d = os.path.join(str(root), S.name)
        os.makedirs(d, exist_ok=True)
        out.append(scrub(scenario(S, d, *args, **kwargs), d))
    return out


# wall-clock fields: the journal's stamp, the crc over it and the bytes
# it takes (its digits vary), save and fsync timings, the loop's
# heartbeat age
WALL = frozenset({"t", "crc", "bytes", "last_s", "total_s", "fsync_lag_s",
                  "loop_age_s", "journal_fsync_lag_s"})


def scrub(obj, root=None):
    """``obj`` without wall-clock fields, with ``root`` read as ``<root>``."""
    if isinstance(obj, dict):
        return {k: scrub(v, root) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, (list, tuple)):
        return [scrub(v, root) for v in obj]
    if isinstance(obj, str) and root and root in obj:
        return obj.replace(root, "<root>")
    return obj


def _artifact(S, art):
    """A stored model artifact in the port's counter names, unsigned (a
    placeholder artifact that is no model stays as it is)."""
    if not S.port:
        try:
            return from_jax_artifact(art)
        except (KeyError, ValueError):
            pass
    return {k: v for k, v in art.items() if k != "signature"}


def store_state(S, store):
    """Every entry and model artifact of a store (plain or sharded)."""
    entries = {e.key: e.to_dict() for e in store.entries()}
    models = {}
    for key in store.model_keys():
        kind, space, bucket, hw = key.split("|")
        models[key] = _artifact(S, store.get_model_dict(space, bucket, hw,
                                                        kind=kind))
    return {"entries": entries, "models": models}


def journal_events(S, path):
    """The journal's records (wall clock left out) and its replay stats."""
    events, stats = S.journal.replay(path)
    return {"events": scrub(events), "replay": stats.to_dict()}


def make_daemon(S, store=None, workers=4, **kw):
    """A daemon over a ``VirtualWorkerPool`` driven in process (no socket,
    no loop thread), as the JAX tests drive theirs."""
    d = S.service.TuningDaemon(
        S.fleet.VirtualWorkerPool(workers=workers),
        store if store is not None else S.tuning.ConfigStore(),
        default_trial_budget=kw.pop("default_trial_budget", 6), **kw)
    d.tuner.begin()
    return d


def drive(d, until, max_iters=2000):
    for _ in range(max_iters):
        if until():
            return
        d._admit_pending()
        d.tuner.step(max_wait=0.01)
        d._meter()
    raise AssertionError("daemon did not converge")


def submit_kernel(S, d, tenant, kernel="matmul", input="2048", hw=HW,
                  **kw):
    return d.handle(S.P.validate_request(dict(
        op="submit", kind="kernel", tenant=tenant, kernel=kernel,
        input=input, hardware=hw, **kw)))


def stats(d):
    """The ``stats`` op's answer."""
    return d.handle({"op": "stats"})


def settle(d):
    """Finish the daemon's fleet in process: every publish lands in the
    store before it is read."""
    d.tuner.stop()
    while d.tuner.step(max_wait=0.01):
        pass
    d.tuner.finish()


def final_state(S, d):
    """Tenants, ``stats`` and the store once the fleet has settled (no
    publish still training on the trainer thread)."""
    settle(d)
    return {"tenants": d.tenants.snapshot(), "stats": stats(d),
            "store": store_state(S, d.store)}
