"""Fleet tuning CLI: many (problem × hardware) jobs, one pool.

Builds ``TuningJob``s for every requested problem (registry kernels and
inputs, ``--problem kind:name`` specs, or ``--system ARCH``), runs them
through a ``FleetTuner`` over the chosen worker backend, and persists
tuned configs + portable model artifacts into a shared ``ConfigStore`` —
so re-running with more shapes warm-starts from what the fleet already
learned.

By default every test is MEASURED on the card: one subprocess lane a
visible CUDA card, each building the kernels at first use and timing them
there, with ``--hw`` the spec detected for the card::

    PYTHONPATH=src python -m repro_torch.launch.fleet \\
        --kernels matmul,conv2d --inputs 2048,4096 \\
        --store fleet_store.json --budget 25 --out fleet.json

Pricing on the cost model, or measuring the plain versions on the CPU,
happens only when asked::

    # priced on the cost model, 4 virtual lanes
    PYTHONPATH=src python -m repro_torch.launch.fleet --backend virtual \\
        --workers 4 --kernels matmul,transpose --hw h100_sxm,h100_pcie

    # measured on the CPU (the kernels' plain versions), for tests
    PYTHONPATH=src python -m repro_torch.launch.fleet --devices cpu \\
        --hw h100_sxm --kernels matmul --inputs 128 --budget 4

Whole-system mode tunes the kernel tiles, the train-step sharding layout
and the serve geometry of one model-zoo entry through one fleet and one
store; kernel jobs are measured on the cards (or priced with ``--backend
virtual``), and the sharding and serve jobs, which name no kernel, are
always priced on the cost model, in this process::

    PYTHONPATH=src python -m repro_torch.launch.fleet --system qwen2.5-3b \\
        --hw h100_sxm --store system_store.json

    # or cherry-pick registered problems by kind:name spec
    PYTHONPATH=src python -m repro_torch.launch.fleet --backend virtual \\
        --problem sharding:qwen2.5-3b/train_4k --problem serve:p9n9
"""
from __future__ import annotations

import argparse
import json
import time


def visible_cards():
    """``cuda:N`` for every visible card (empty without CUDA)."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def build_pool(backend: str, workers: int, devices):
    """The worker pool: virtual and thread lanes by ``workers``; measuring
    subprocess lanes one a device."""
    from repro_torch.fleet import (SubprocessWorkerPool, ThreadWorkerPool,
                                   VirtualWorkerPool)

    if backend == "virtual":
        return VirtualWorkerPool(workers=workers)
    if backend == "thread":
        return ThreadWorkerPool(workers=workers)
    if backend == "subprocess":
        return SubprocessWorkerPool(devices=devices)
    raise ValueError(f"unknown backend {backend!r}")


def _problems(args):
    """The problems of --system, --problem or --kernels/--inputs, and
    whether the jobs keep the kernel registry's ``kernel/input@hw``
    names (--kernels) or take ``kind:name@hw`` (the other two)."""
    from repro_torch.kernels.registry import BENCHMARKS
    from repro_torch.tuning.problem import (KernelProblem, parse_problem,
                                            system_problems)

    if args.system is not None:
        try:
            return system_problems(args.system), False
        except KeyError as exc:
            raise SystemExit(f"--system: {exc}")
    if args.problem:
        specs = [s.strip() for chunk in args.problem
                 for s in chunk.split(",") if s.strip()]
        out = []
        for spec in specs:
            try:
                out.append(parse_problem(spec))
            except (KeyError, ValueError) as exc:
                raise SystemExit(f"--problem {spec!r}: {exc}")
        return out, False
    kernels = [k.strip() for k in args.kernels.split(",") if k.strip()]
    if args.inputs is not None:
        inputs = [i.strip() for i in args.inputs.split(",")]
        if len(inputs) != len(kernels):
            raise SystemExit(
                "--inputs must list one key per --kernels entry")
    else:
        inputs = []
        for k in kernels:
            bm = BENCHMARKS[k]
            inputs.append(next(key for key, v in bm.inputs.items()
                               if v is bm.default_input))
    try:
        return [KernelProblem(k, i) for k, i in zip(kernels, inputs)], True
    except KeyError as exc:
        raise SystemExit(f"cannot build the jobs: {exc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="matmul,transpose",
                    help="comma-separated registry kernel names")
    ap.add_argument("--inputs", default=None,
                    help="comma-separated input keys, one per kernel "
                    "(default: each kernel's default input)")
    ap.add_argument("--problem", action="append", default=None,
                    help="tune registered problems 'kind:name' instead of "
                    "--kernels (repeatable / comma-separated), e.g. "
                    "kernel:matmul/2048, sharding:qwen2.5-3b/train_4k, "
                    "serve:p9n9")
    ap.add_argument("--system", default=None,
                    help="whole-system mode: one invocation tunes kernel "
                    "tiles (measured on the cards unless --backend "
                    "virtual) + train-step sharding + serve geometry "
                    "(priced) for this model-zoo entry through one fleet "
                    "and one store (overrides --kernels/--problem)")
    ap.add_argument("--hw", default=None,
                    help="comma-separated hardware names (naming drift ok: "
                    "H100-SXM == h100_sxm); default: the spec detected for "
                    "the card (measured), h100_sxm (--backend virtual)")
    ap.add_argument("--backend", default="subprocess",
                    choices=("subprocess", "thread", "virtual"),
                    help="subprocess (default) and thread measure on "
                    "--devices; virtual prices on the cost model")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices the tests are measured "
                    "on (cuda:N, or cpu for the plain versions); default: "
                    "every visible CUDA card, one subprocess lane each")
    ap.add_argument("--workers", type=int, default=None,
                    help="lanes of the virtual and thread backends "
                    "(default: 4 virtual, one a device for thread)")
    ap.add_argument("--in-flight", type=int, default=None,
                    help="outstanding tests pool-wide (default: the lanes)")
    ap.add_argument("--in-flight-max", type=int, default=None,
                    help="make in_flight ELASTIC between [--in-flight, "
                    "this]: the driver grows/shrinks outstanding work from "
                    "pool backpressure (live lanes, measurement variance)")
    ap.add_argument("--retries", type=int, default=2,
                    help="max resubmissions per failed test on another "
                    "lane (default: 2)")
    ap.add_argument("--known-bad-after", type=int, default=2,
                    help="mark a config known-bad after this many "
                    "failures of its own measurement (default: 2)")
    ap.add_argument("--straggler-factor", type=float, default=None,
                    help="time out tests outstanding longer than this "
                    "factor times the job's rolling cost estimate and "
                    "resubmit them elsewhere (default: disabled)")
    ap.add_argument("--park-factor", type=float, default=None,
                    help="park model-backed jobs whose measured best is "
                    "already within this factor of their predicted best "
                    "runtime (default: disabled)")
    ap.add_argument("--budget", type=int, default=25,
                    help="empirical-test budget per job")
    ap.add_argument("--searcher", default=None,
                    help="force one searcher for every job (default: "
                    "warm_start on store hit, random cold)")
    ap.add_argument("--store", default=None,
                    help="shared ConfigStore path (default: in-memory)")
    ap.add_argument("--no-publish", action="store_true",
                    help="do not train/publish missing model artifacts")
    ap.add_argument("--transfer", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="when every exact-space stored model misses a "
                    "job, warm-start it from the most structurally "
                    "similar same-kind space's model (--no-transfer pins "
                    "the exact-space ladder)")
    ap.add_argument("--transfer-threshold", type=float, default=None,
                    help="minimum structural similarity (counter Jaccard "
                    "x parameter overlap, in [0,1]) a cross-space model "
                    "must clear to be used (default: the library's "
                    "conservative threshold)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.fleet import FleetTuner, job_from_problem
    from repro_torch.fleet.job import device_spec
    from repro_torch.tuning import ConfigStore

    problems, registry_names = _problems(args)
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
    hws = ([h.strip() for h in args.hw.split(",") if h.strip()]
           if args.hw is not None else [None if measured else "h100_sxm"])
    jobs = []
    n = 0
    try:
        for problem, hw in ((p, h) for p in problems for h in hws):
            device = None
            if problem.kernel is None:
                # a sharding or serve problem names no kernel: priced, on
                # the given spec or the first lane's card's
                if hw is None:
                    hw = device_spec(devices[0], None)
            elif measured:
                device = devices[n % len(devices)]
                n += 1
            job = job_from_problem(
                problem, hw, budget=args.budget, seed=args.seed,
                searcher=args.searcher, device=device)
            if registry_names:
                job.name = f"{problem.name}@{job.hardware_key}"
            jobs.append(job)
    except (KeyError, ValueError, RuntimeError) as exc:
        raise SystemExit(f"cannot build the jobs: {exc}")
    workers = args.workers if args.workers is not None else (
        len(devices) if measured else 4)
    store = ConfigStore(args.store)
    pool = build_pool(args.backend, workers, devices)
    t0 = time.time()
    tuner = FleetTuner(jobs, pool, store=store,
                       in_flight=args.in_flight,
                       in_flight_max=args.in_flight_max,
                       retries=args.retries,
                       known_bad_after=args.known_bad_after,
                       straggler_factor=args.straggler_factor,
                       park_factor=args.park_factor,
                       publish_models=not args.no_publish,
                       transfer=args.transfer,
                       transfer_threshold=args.transfer_threshold,
                       verbose=args.verbose)
    # SIGINT/SIGTERM drain: stop filling, collect what is in flight,
    # publish/report the completed jobs
    from repro_torch.launch.signals import install_drain_handlers

    draining = install_drain_handlers(tuner.stop)
    try:
        tuner.begin()
        while tuner.step(max_wait=0.5):
            pass
        report = tuner.finish()
        lanes = pool.lane_info() if hasattr(pool, "lane_info") else None
    finally:
        pool.close()
    wall = time.time() - t0

    where = (f"measured on {','.join(devices)}" if measured
             else "priced on the cost model")
    print(f"[fleet] {len(jobs)} jobs on {args.backend} backend "
          f"({pool.workers} workers, in_flight={report.in_flight}, {where})"
          + ("  [DRAINED EARLY]" if draining() else ""))
    for r in sorted(report.results, key=lambda r: r.job):
        mark = " [cancelled]" if r.cancelled else ""
        if r.transfer_from is not None:
            mark += (f" [transfer {r.transfer_from} "
                     f"~{r.transfer_similarity:.2f}]")
        elif r.warm_from is not None:
            mark += f" [warm {r.warm_from}]"
        print(f"  {r.job:40s} {'warm' if r.warm_started else 'cold':4s} "
              f"{r.trials:3d} trials  best {r.best_runtime*1e3:9.4f}ms  "
              f"{r.best_config}{mark}")
    print(f"[fleet] pool clock {report.elapsed:.3f}s for "
          f"{report.busy:.3f} worker-seconds of measurement "
          f"(x{report.busy / max(report.elapsed, 1e-12):.2f} concurrency); "
          f"host wall {wall:.1f}s")
    if lanes is not None:
        for lane in lanes:
            print(f"[fleet] lane {lane['lane']} on {lane['device']} "
                  f"({lane['device_name']}): launches {lane['launches']}")
    if report.failures or report.timeouts or report.parked:
        print(f"[fleet] faults: {report.failures} failed attempts "
              f"({report.known_bad} known-bad configs), "
              f"{report.timeouts} stragglers timed out, "
              f"{report.abandoned:.3f}s abandoned work charged to busy, "
              f"{report.parked} jobs parked, max retries used "
              f"{report.max_retries_used}")
    if args.store:
        print(f"[fleet] store -> {args.store} ({len(store)} entries)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "backend": args.backend, "workers": pool.workers,
                "devices": devices, "lanes": lanes,
                "in_flight": report.in_flight,
                "pool_elapsed_s": report.elapsed, "busy_s": report.busy,
                "host_wall_s": wall,
                "failures": report.failures,
                "timeouts": report.timeouts,
                "known_bad": report.known_bad,
                "abandoned_s": report.abandoned,
                "parked": report.parked,
                "drained": draining(),
                "jobs": [{
                    "job": r.job, "bucket": r.bucket, "hardware": r.hardware,
                    "searcher": r.searcher, "warm_started": r.warm_started,
                    "warm_from": r.warm_from,
                    "trials": r.trials, "best_runtime_s": r.best_runtime,
                    "elapsed_s": r.elapsed, "busy_s": r.busy,
                    "best_config": r.best_config,
                    "failures": r.failures, "known_bad": r.known_bad,
                    "parked": r.parked, "cancelled": r.cancelled,
                    "transfer_from": r.transfer_from,
                    "transfer_similarity": r.transfer_similarity,
                } for r in report.results],
            }, f, indent=2)
        print(f"[fleet] -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
