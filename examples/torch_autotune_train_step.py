"""The paper's profile-based searcher autotunes the DISTRIBUTED STEP CONFIG
of qwen2.5-3b train_4k on the production mesh (16x16), through the public
``repro_torch.tuning`` API.

Training phase: ``TuningSession.train_on_evaluator`` counts a deliberate
sample of the step space with the dry run (``CompiledStepEvaluator``: the
step run on fake tensors as rank 0 of a fake process group, priced at the
H100's rates) and fits the TP -> PC_ops model.  Autotuning: profile ->
bottleneck -> ΔPC -> biased step, driven ask-tell, against random search
at the same budget; the three share the count cache.  No card is needed:
nothing is allocated or launched.  ``--smoke`` tunes the reduced config of
``--arch`` under its name.

    PYTHONPATH=src python examples/torch_autotune_train_step.py \
        [--arch qwen2.5-3b] [--budget 10] [--out step_tune.json]
"""
import argparse
import json
import time

from repro_torch.configs import SMOKES
from repro_torch.core.step_tuner import CompiledStepEvaluator
from repro_torch.tuning import TuningSession


def run(arch="qwen2.5-3b", shape="train_4k", budget=10, train_samples=14,
        out="step_tune.json", save_model=None, smoke=False, say=print):
    """Train on a sample of the step space, then profile against random
    at ``budget`` tests each; writes and returns the results."""
    t0 = time.time()
    config = SMOKES[arch] if smoke else None
    ev_train = CompiledStepEvaluator(arch, shape, config=config)
    space = ev_train.space
    say(f"step space: {len(space)} configs")

    # --- training phase: deliberate sample -> TP->PC model ---------------
    session = TuningSession(space, seed=0)
    say(f"training phase: counting <= {train_samples} sampled configs")
    session.train_on_evaluator(ev_train, values_per_param=2,
                               max_samples=train_samples)
    say(f"model trained ({ev_train.compile_seconds:.0f}s of counts, "
        f"{ev_train.steps} empirical tests)")
    if save_model:
        session.save_model(save_model)
        say(f"model artifact -> {save_model}")

    # --- autotuning: profile-based vs random at the same budget ----------
    results = {"space": len(space), "train_samples": ev_train.steps,
               "budget": budget}
    for label in ("profile", "random"):
        ev = CompiledStepEvaluator(arch, shape, config=config)
        ev._cache.update(ev_train._cache)  # share the count cache
        extra = {"n": 3} if label == "profile" else {}
        session.tune(budget=budget, searcher=label, evaluator=ev, seed=1,
                     **extra)
        best = space[ev.best_index]
        say(f"[{label}] best {ev.best_runtime*1e3:.1f}ms after "
            f"{ev.steps} tests: {best}")
        results[label] = {"best_ms": ev.best_runtime * 1e3,
                          "best_config": best, "steps": ev.steps}
    results["train_best_ms"] = ev_train.best_runtime * 1e3
    results["train_best_config"] = space[ev_train.best_index]
    results["total_seconds"] = time.time() - t0
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    say(f"done in {time.time()-t0:.0f}s -> {out}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--budget", type=int, default=10)
    ap.add_argument("--train-samples", type=int, default=14)
    ap.add_argument("--out", default="step_tune.json")
    ap.add_argument("--save-model", default=None,
                    help="also write the trained TP->PC model JSON artifact")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch, under its name")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, args.budget, args.train_samples, args.out,
        args.save_model, args.smoke)


if __name__ == "__main__":
    main()
