"""The step-config tuning CLI, over the public ``repro_torch.tuning`` API.

Tunes the train-step configuration (microbatches, remat, loss chunking,
attention chunk, FSDP) of an architecture with the paper's two-phase flow
made operational:

  train + save:   --save-model step_tppc.json  (train the TP->PC model here)
  load + tune:    --load-model step_tppc.json  (skip the training tests:
                  the artifact may come from a DIFFERENT machine)

Two backends (``core.step_tuner``): ``--backend priced`` (the default)
counts a production cell's step through the dry run and prices its
roofline at the H100's rates (``--shape``); ``--backend measured`` times
the real step of ``--batch`` × ``--seq`` on the card (``--device cpu``
runs it on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2.5-3b \
        [--searcher profile] [--budget 10] [--save-model step_tppc.json]
    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen1.5-0.5b \
        --backend measured --batch 8 --seq 2048 --budget 8

``--problem kind:name`` tunes a registered ``TuningProblem`` through the
fleet machinery instead (priced on ``--hw``, default h100_sxm).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.step_tuner import (CompiledStepEvaluator,
                                         MeasuredStepEvaluator)
from repro_torch.tuning import SEARCHERS, TuningSession


def _tune_problem(args) -> int:
    """``--problem kind:name`` mode: tune one registered ``TuningProblem``
    through the fleet machinery (problem evaluator or cost-model replay)."""
    from repro_torch.fleet import (FleetTuner, VirtualWorkerPool,
                                   job_from_problem)
    from repro_torch.tuning import ConfigStore
    from repro_torch.tuning.problem import parse_problem

    try:
        problem = parse_problem(args.problem)
    except (KeyError, ValueError) as exc:
        raise SystemExit(f"--problem: {exc}")
    t0 = time.time()
    job = job_from_problem(problem, args.hw, budget=args.budget,
                           seed=args.seed, searcher=args.searcher)
    store = ConfigStore(args.store)
    pool = VirtualWorkerPool(workers=1)
    try:
        report = FleetTuner([job], pool, store=store,
                            transfer=args.transfer,
                            transfer_threshold=args.transfer_threshold).run()
    finally:
        pool.close()
    r = report.results[0]
    warm = ""
    if r.transfer_from is not None:
        warm = (f", transfer from {r.transfer_from} "
                f"(similarity {r.transfer_similarity:.3f})")
    elif r.warm_started:
        warm = ", warm"
    print(f"[tune] {problem.spec} on {args.hw} ({r.searcher}{warm}): "
          f"best {r.best_runtime*1e3:.3f}ms after {r.trials} tests")
    print(f"[tune] best config: {r.best_config}")
    if args.store:
        print(f"[tune] store -> {args.store} ({len(store)} entries)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"problem": problem.spec, "hardware": args.hw,
                       "searcher": r.searcher,
                       "best_ms": r.best_runtime * 1e3,
                       "best_config": r.best_config, "trials": r.trials,
                       "history": r.history,
                       "seconds": time.time() - t0}, f, indent=2)
        print(f"[tune] -> {args.out}")
    return 0


def _evaluator(args):
    if args.backend == "measured":
        return MeasuredStepEvaluator(args.arch, args.batch, args.seq,
                                     device=args.device, seed=args.seed)
    return CompiledStepEvaluator(args.arch, args.shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="train_4k",
                    help="the production cell the priced backend counts")
    ap.add_argument("--backend", default="priced",
                    choices=("priced", "measured"),
                    help="priced: the dry run's roofline of --shape; "
                    "measured: real steps of --batch x --seq on the card")
    ap.add_argument("--batch", type=int, default=8,
                    help="measured backend: the step's global batch")
    ap.add_argument("--seq", type=int, default=2048,
                    help="measured backend: the step's sequence length")
    ap.add_argument("--device", default=None,
                    help="measured backend: 'cpu' to run the steps on the "
                    "CPU (default: the card)")
    ap.add_argument("--problem", default=None,
                    help="tune a registered problem 'kind:name' instead of "
                    "the train step (e.g. kernel:matmul/128, "
                    "sharding:qwen2.5-3b/train_4k, serve:p9n9); see "
                    "repro_torch.tuning.problem_kinds()")
    ap.add_argument("--hw", default="h100_sxm",
                    help="hardware target for --problem mode")
    ap.add_argument("--store", default=None,
                    help="ConfigStore path for --problem mode artifacts")
    from repro_torch.tuning.signature import DEFAULT_TRANSFER_THRESHOLD
    ap.add_argument("--transfer", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--problem mode: when every exact-space stored "
                    "model misses, warm-start from the most structurally "
                    "similar same-kind space's model (--no-transfer pins "
                    "the legacy exact-space ladder)")
    ap.add_argument("--transfer-threshold", type=float,
                    default=DEFAULT_TRANSFER_THRESHOLD,
                    help="minimum structural similarity (counter Jaccard "
                    "x parameter overlap, in [0,1]) a cross-space model "
                    "must clear to be used")
    ap.add_argument("--searcher", default=None,
                    choices=sorted(SEARCHERS))
    ap.add_argument("--budget", type=int, default=10)
    ap.add_argument("--in-flight", type=int, default=1,
                    help="outstanding empirical tests to keep submitted "
                    "(the evaluators are thread-safe; >1 only pays off "
                    "with an async evaluation backend)")
    ap.add_argument("--train-samples", type=int, default=14)
    ap.add_argument("--save-model", default=None)
    ap.add_argument("--load-model", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.problem:
        # fleet-auto searcher when unset: warm_start on store hit, else cold
        return _tune_problem(args)
    if args.searcher is None:
        args.searcher = "profile"

    t0 = time.time()
    ev = _evaluator(args)
    session = TuningSession(ev.space, seed=args.seed)

    needs_model = args.searcher in ("profile", "profile_local")
    if args.load_model:
        session.load_model(args.load_model)
        print(f"[tune] loaded model artifact {args.load_model}")
    elif needs_model:
        print(f"[tune] training phase: <= {args.train_samples} tests")
        t_train = time.time()
        session.train_on_evaluator(ev, values_per_param=2,
                                   max_samples=args.train_samples)
        print(f"[tune] model trained ({time.time() - t_train:.0f}s)")
    if args.save_model and session.model is not None:
        session.save_model(args.save_model)
        print(f"[tune] model artifact -> {args.save_model}")

    # fresh evaluator for the tuning phase (training already spent steps on
    # ev's account); share the cache so repeats stay free
    ev_tune = _evaluator(args)
    ev_tune._cache.update(ev._cache)
    extra = {"n": 3} if needs_model else {}
    result = session.tune(budget=args.budget, searcher=args.searcher,
                          evaluator=ev_tune, in_flight=args.in_flight,
                          **extra)
    print(f"[tune] {args.searcher}: best {result.best_runtime*1e3:.1f}ms "
          f"after {result.steps} empirical tests")
    print(f"[tune] best config: {result.best_config}")
    if args.out:
        rec = {"arch": args.arch,
               "shape": args.shape if args.backend == "priced" else None,
               "backend": args.backend, "searcher": args.searcher,
               "best_ms": result.best_runtime * 1e3,
               "best_config": result.best_config,
               "steps": result.steps,
               "history": result.history,
               "seconds": time.time() - t0}
        if args.backend == "measured":
            rec.update(batch=args.batch, seq=args.seq,
                       tests=ev.tests + ev_tune.tests,
                       ooms=ev.ooms + ev_tune.ooms)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[tune] -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
