"""The readings the check's limits are set from, on the card at each
configuration's own size (not run by the benchmark's runs):

    python3 onchip_bench/control.py --seeds 12 --fault-seeds 3

* ``kernel_rel_err``: the port's kernel at every configuration of the space
  on each seed's inputs (the lower reading is the largest), and the
  control, the plain reference computed in TF32, on the same inputs (the
  upper reading is the smallest);
* ``best_outside``: the count of episodes in a short window of each cell
  with the session's answer altered where it is produced (each tune
  returns the slowest configuration it tested) on ``--fault-seeds``
  seeds.

Prints one JSON object and writes it to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1] / "src"))

SEEDS = (2**31 + 17, 3, 77, 2**31 + 1000003, 12345, 999, 2**32 + 5, 41,
         2**31 - 1, 7, 314159, 2**31 + 424242, 5, 2**33 + 9, 271828, 11)


def kernel_readings(cell, seeds, device):
    import torch

    import harness
    from repro_torch.kernels.registry import BENCHMARKS

    k = cell.kernel
    bench = BENCHMARKS[k.KERNEL]
    inp = k.make_input(cell.config["input"])
    space = k.make_space(bench, inp)
    well = {space.index_of(c) for c in cell.config["well_set"]}
    program, program_well, control = [], [], []
    for seed in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2**64)
        args = k.make_args(inp, g, device)
        ref = cell.reference.reference(*args)
        errs = [harness.rel_err(bench.run(space[i], *args), ref)
                for i in range(len(space))]
        program.append(max(errs))
        program_well.append(max(errs[i] for i in well))
        control.append(harness.rel_err(cell.reference.control(*args), ref))
        del args, ref
        torch.cuda.empty_cache()
    return {"seeds": list(seeds), "program_every_config": program,
            "program_well_set": program_well, "control": control,
            "lower": max(program), "upper": min(control)}


def fault_readings(cell, seeds, seconds, device):
    """``best_outside`` of short windows whose tunes return the slowest
    configuration they tested."""
    import harness
    from repro_torch.tuning import TuningSession

    tune = TuningSession.tune

    def altered(self, *args, evaluator=None, **kw):
        result = tune(self, *args, evaluator=evaluator, **kw)
        slowest = max(evaluator.history(), key=lambda h: h[1])[0]
        result.best_config = self.space[slowest]
        return result

    TuningSession.tune = altered
    try:
        out = [harness.run_cell(cell, seed, seconds, False, device,
                                time.perf_counter())["checks"]
               ["best_outside"]["value"] for seed in seeds]
    finally:
        TuningSession.tune = tune
    return {"seeds": list(seeds), "best_outside": out, "upper": min(out)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--fault-seconds", type=float, default=5.0)
    ap.add_argument("--out", default="build/onchip_bench/control.json")
    args = ap.parse_args()
    import torch

    import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA card is visible")
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    out = {"card": torch.cuda.get_device_name(device), "configs": {},
           "cells": {}}
    done = set()
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"])
        if w["config"] not in done:
            done.add(w["config"])
            out["configs"][w["config"]] = kernel_readings(
                cell, SEEDS[:args.seeds], device)
            harness.log(f"[control] {w['config']}: "
                        f"{json.dumps(out['configs'][w['config']])}")
        out["cells"][w["name"]] = fault_readings(
            cell, SEEDS[-args.fault_seeds:], args.fault_seconds, device)
        harness.log(f"[fault] {w['name']}: "
                    f"{json.dumps(out['cells'][w['name']])}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
