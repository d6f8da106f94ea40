"""``repro_torch.service`` — tuning-as-a-service: the multi-tenant fleet
daemon, on the card.

The paper's economics argument is amortization: counter-trained TP→PC
models pay for themselves when their cost is spread across hardware ports
and input changes.  A long-lived shared service is that argument at
deployment scale — every tenant's published model warm-starts the next
tenant, and a recurring (kernel, input bucket, hardware) key is answered
straight from the shared store with ZERO trials.  On a measuring pool a
tenant's budget meters real seconds on the card and a store hit saves
real launches.

* ``protocol``  — the JSON-lines wire protocol (``submit`` / ``status`` /
  ``result`` / ``cancel`` / ``stats`` / ``shutdown``) with validation,
  the JAX package's byte for byte, so either package's client talks to
  either daemon;
* ``daemon``    — ``TuningDaemon``: a localhost socket server multiplexing
  many tenants onto ONE elastic ``FleetTuner`` over one worker pool, with
  graceful drain on shutdown; on a pool with devices every kernel request
  is measured on a card of the hardware it names;
* ``tenants``   — admission control and per-tenant worker-seconds budget
  metering (``EvalAccount.snapshot()``/``diff()``), least-spent-first
  fairness so no tenant starves while a cold tenant burns budget;
* ``shards``    — ``ShardedConfigStore``: one corpus hash-partitioned
  across store files, so many daemons share it without lock convoys;
* ``client``    — ``ServiceClient`` (blocking, self-healing reconnect)
  and ``AsyncServiceClient`` (handle-based) speakers of the protocol;
* ``journal``   — ``RequestJournal``: the daemon's checksummed
  write-ahead request journal; replaying it under ``--recover``
  rebuilds the request table after a crash;
* ``health``    — liveness/readiness probes behind the ``health`` op.

CLI: ``python -m repro_torch.launch.daemon`` (``--journal``/``--recover``
for crash safety).
"""
from repro_torch.service.client import (AsyncServiceClient, PendingTuning,
                                        ServiceClient, ServiceError,
                                        ServiceUnavailable)
from repro_torch.service.daemon import RequestRecord, TuningDaemon
from repro_torch.service.health import HealthReport
from repro_torch.service.journal import ReplayStats, RequestJournal
from repro_torch.service.protocol import (PROTOCOL, PROTOCOL_VERSION,
                                          ProtocolError, validate_request)
from repro_torch.service.shards import ShardedConfigStore
from repro_torch.service.tenants import (AdmissionError, TenantManager,
                                         TenantState)

__all__ = [
    "AdmissionError", "AsyncServiceClient", "HealthReport", "PROTOCOL",
    "PROTOCOL_VERSION", "PendingTuning", "ProtocolError", "ReplayStats",
    "RequestJournal", "RequestRecord", "ServiceClient", "ServiceError",
    "ServiceUnavailable", "ShardedConfigStore", "TenantManager",
    "TenantState", "TuningDaemon", "validate_request",
]
