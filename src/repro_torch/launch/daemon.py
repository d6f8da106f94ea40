"""Tuning-service daemon CLI: run a multi-tenant fleet behind a socket.

Starts a ``TuningDaemon`` — one worker pool, one elastic fleet, one
shared (optionally sharded) config/model corpus — listening for
JSON-lines tuning requests on localhost.  SIGINT/SIGTERM drain
gracefully: in-flight empirical tests finish, unfinished jobs resolve as
cancelled partials, the store is flushed.

By default every test is MEASURED on the card: one subprocess lane a
visible CUDA card, and a kernel request is tuned on a card of the
hardware it names (a request for hardware the daemon has no card of is
refused)::

    # sharded corpus, ephemeral port printed on start
    PYTHONPATH=src python -m repro_torch.launch.daemon \\
        --store-dir corpus-card/ --port 7421

    # talk to it (either package's client speaks the protocol)
    python -c "from repro_torch.service import ServiceClient; \\
        c = ServiceClient('127.0.0.1:7421'); \\
        r = c.submit_kernel('me', 'conv2d', 'h100_sxm', input='4096'); \\
        print(c.result(r['request_id'], timeout=600))"

Pricing on the cost model, or measuring the plain versions on the CPU,
happens only when asked: ``--backend virtual`` prices (as the JAX
package's daemon does), ``--devices cpu`` measures the plain versions
standing in for an ``h100_sxm`` card (for tests).  Without a visible card
and without either flag the daemon refuses to start.  The three keep
their results under the same keys, so each needs a store (and journal)
of its own: the daemon refuses one that another of them wrote.

Per-tenant worker-seconds budgets arrive with the requests themselves
(``tenant_budget_s`` on submit); ``--default-tenant-budget`` applies one
to tenants that never declare any.  On a measuring daemon they meter
seconds of tests on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _lanes(pool):
    """Each subprocess lane's device, card name and kernel launches."""
    return pool.lane_info() if hasattr(pool, "lane_info") else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0: bind an ephemeral port and print it")
    ap.add_argument("--backend", default="subprocess",
                    choices=("subprocess", "virtual"),
                    help="subprocess (default) measures on --devices, one "
                    "lane a device; virtual prices on the cost model")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices the tests are measured "
                    "on (cuda:N, or cpu for the plain versions); default: "
                    "every visible CUDA card, one subprocess lane each")
    ap.add_argument("--workers", type=int, default=4,
                    help="lanes of the virtual backend")
    ap.add_argument("--store-dir", default=None,
                    help="sharded corpus directory (the default)")
    ap.add_argument("--store", default=None,
                    help="single-file ConfigStore path instead of a "
                    "sharded corpus")
    ap.add_argument("--shards", type=int, default=4,
                    help="shard count when creating a new --store-dir")
    ap.add_argument("--budget", type=int, default=16,
                    help="default per-request trial budget")
    ap.add_argument("--max-active-jobs", type=int, default=32)
    ap.add_argument("--max-tenants", type=int, default=64)
    ap.add_argument("--max-active-per-tenant", type=int, default=4)
    ap.add_argument("--max-queued-per-tenant", type=int, default=16)
    ap.add_argument("--default-tenant-budget", type=float, default=None,
                    help="worker-seconds budget for tenants that never "
                    "declare one (default: unlimited)")
    ap.add_argument("--in-flight", type=int, default=None)
    ap.add_argument("--in-flight-max", type=int, default=None)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--straggler-factor", type=float, default=None)
    ap.add_argument("--park-factor", type=float, default=None)
    ap.add_argument("--no-publish", action="store_true",
                    help="do not train/publish missing model artifacts")
    ap.add_argument("--gc-keep-hardware", default=None,
                    help="comma-separated hardware keys to KEEP on "
                    "periodic store GC (default: GC disabled)")
    ap.add_argument("--gc-every", type=float, default=60.0,
                    help="pool-seconds between GC passes")
    ap.add_argument("--journal", default=None,
                    help="write-ahead request journal path (default: "
                    "<store-dir>/journal.jsonl when using a store dir)")
    ap.add_argument("--no-journal", action="store_true",
                    help="disable the request journal entirely")
    ap.add_argument("--fsync", default="batch",
                    choices=("always", "batch", "off"),
                    help="journal durability mode: 'always' fsyncs every "
                    "record inline, 'batch' (default) group-commits — "
                    "acks still wait for the fsync covering their "
                    "records, but one flush covers a whole burst — "
                    "'off' never fsyncs (machine-crash unsafe, "
                    "process-kill safe)")
    ap.add_argument("--recover", action="store_true",
                    help="replay the journal on startup: restore "
                    "resolved requests, resubmit interrupted ones with "
                    "their remaining budget, restore tenant spend")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.fleet import build_pool, visible_cards
    from repro_torch.launch.signals import install_drain_handlers
    from repro_torch.service import ShardedConfigStore, TuningDaemon
    from repro_torch.service.journal import RequestJournal
    from repro_torch.service.tenants import TenantManager
    from repro_torch.tuning import ConfigStore

    measured = args.backend != "virtual"
    devices = None
    if measured:
        devices = ([d.strip() for d in args.devices.split(",") if d.strip()]
                   if args.devices is not None else visible_cards())
        if not devices:
            raise SystemExit(
                "no CUDA card is visible: pass --devices cpu to measure the "
                "plain versions on the CPU, or --backend virtual to price "
                "on the cost model")
    elif args.devices is not None:
        raise SystemExit("--backend virtual prices on the cost model; "
                         "--devices is for the measuring backends")
    if args.store is not None:
        store = ConfigStore(args.store)
        store_root = os.path.dirname(os.path.abspath(args.store))
    else:
        store_root = args.store_dir or "tuning_corpus"
        store = ShardedConfigStore(store_root, n_shards=args.shards)
    journal = None
    if not args.no_journal:
        journal = RequestJournal(
            args.journal or os.path.join(store_root, "journal.jsonl"),
            mode=args.fsync)
    if args.recover and journal is None:
        ap.error("--recover requires a journal (drop --no-journal)")
    t1 = time.perf_counter()
    pool = build_pool(args.backend, args.workers, devices)
    print(f"[daemon] {pool.workers} lane(s) up in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    for lane in _lanes(pool):
        print(f"[daemon] lane {lane['lane']} on {lane['device']} "
              f"({lane['device_name']})", flush=True)
    gc_keep = None
    if args.gc_keep_hardware:
        gc_keep = {"keep_hardware": [h.strip() for h in
                                     args.gc_keep_hardware.split(",")
                                     if h.strip()]}
    t1 = time.perf_counter()
    try:
        daemon = TuningDaemon(
            pool, store, host=args.host, port=args.port,
            tenants=TenantManager(
                max_tenants=args.max_tenants,
                max_active_per_tenant=args.max_active_per_tenant,
                max_queued_per_tenant=args.max_queued_per_tenant,
                default_budget_s=args.default_tenant_budget),
            default_trial_budget=args.budget,
            max_active_jobs=args.max_active_jobs,
            gc_keep=gc_keep, gc_every_s=args.gc_every,
            journal=journal, recover=args.recover,
            verbose=args.verbose,
            in_flight=args.in_flight, in_flight_max=args.in_flight_max,
            retries=args.retries, straggler_factor=args.straggler_factor,
            park_factor=args.park_factor,
            publish_models=not args.no_publish)
        host, port = daemon.start()
    except ValueError as exc:
        pool.close()
        raise SystemExit(f"cannot start the daemon: {exc}")
    except BaseException:
        pool.close()
        raise
    print(f"[daemon] daemon (cards, store, recovery) up in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    if daemon.recovery is not None:
        print(f"[daemon] recovered: {json.dumps(daemon.recovery)}",
              flush=True)
    where = (f"measured on {','.join(devices)}" if measured
             else "priced on the cost model")
    print(f"[daemon] tuning service on {host}:{port} "
          f"({args.backend} backend, {pool.workers} workers, {where}, "
          f"store={store.path})", flush=True)
    install_drain_handlers(daemon.shutdown)
    try:
        daemon.wait()
        lanes = _lanes(pool)
    finally:
        pool.close()
    if daemon.final_report is not None:
        rep = daemon.final_report
        print(f"[daemon] drained: {len(rep.results)} jobs, "
              f"{rep.busy:.3f} worker-seconds on the pool clock")
    for lane in lanes:
        print(f"[daemon] lane {lane['lane']} on {lane['device']} "
              f"({lane['device_name']}): launches {lane['launches']}")
    print(json.dumps({"tenants": daemon.tenants.snapshot()}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
