"""``repro_torch.fleet`` — asynchronous fleet orchestration for autotuning.

Keeps N empirical tests in flight across many (kernel × input bucket ×
hardware) tuning jobs: ``TuningJob``s are scheduled by a ``FleetTuner``
over a worker pool (deterministic virtual clock, in-process threads, or
per-lane subprocesses, one a card when they measure), share one
concurrency-safe ``ConfigStore``, and warm-start from the nearest stored
TP→PC model artifact.  A job is priced on the cost model, or measured on a
card (``device=``):

    from repro_torch.fleet import (FleetTuner, SubprocessWorkerPool,
                                   job_from_registry)
    from repro_torch.tuning import ConfigStore

    jobs = [job_from_registry("matmul", key, None, budget=25,
                              device="cuda:0")
            for key in ("2048", "16x4096")]
    pool = SubprocessWorkerPool(devices=["cuda:0"])
    try:
        report = FleetTuner(jobs, pool,
                            store=ConfigStore("fleet_store.json")).run()
    finally:
        pool.close()

CLI: ``python -m repro_torch.launch.fleet``.
"""
from repro_torch.fleet.job import (JobResult, TuningJob, job_from_problem,
                                   job_from_registry)
from repro_torch.fleet.pool import (FAIL_LANE, FAIL_POOL, FAIL_TEST,
                                    FailedResult, SubprocessWorkerPool,
                                    ThreadWorkerPool, VirtualWorkerPool,
                                    WorkItem, WorkResult)
from repro_torch.fleet.tuner import (FleetReport, FleetTuner,
                                     predicted_runtime_order)

__all__ = [
    "FAIL_LANE", "FAIL_POOL", "FAIL_TEST", "FailedResult", "FleetReport",
    "FleetTuner", "JobResult", "SubprocessWorkerPool", "ThreadWorkerPool",
    "TuningJob", "VirtualWorkerPool", "WorkItem", "WorkResult",
    "job_from_problem", "job_from_registry", "predicted_runtime_order",
]
