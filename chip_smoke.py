#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device  — the card's name, count and power limit; its hardware spec.
2. build   — every CUDA source in ``src/repro_torch/csrc``, with nvcc's
             register / shared-memory / spill report.
3. check   — each kernel against its plain PyTorch version on the card, at
             every registry input plus a ragged one, smallest and largest
             tiles, both loop orders (TF32 off).
4. sweep   — ``DeviceKernelEvaluator`` over the whole GEMM space at 2048³
             and at 16x4096x4096: the measured ground truth.
5. main    — Algorithm 1 live: ``train_on_evaluator`` on 16x4096x4096,
             ``save_model``; a new session on 2048³ ``load_model`` and
             ``tune(budget=25, searcher="profile")`` through the card
             evaluator.  Launch counts are zeroed just before and read just
             after; every kernel of the path must have launched.
6. replay  — the paper's trials-to-well metric, profile vs random searcher,
             100 seeds each, replayed on both measured records.
7. report  — one JSON line with each kernel's times, bound and launches,
             the card's name and power limit, and a last line
             ``{"ok": true, "device": {...}}``.

The script needs CUDA and the checkout's ``src/``; without either it exits
non-zero before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARTIFACT_DIR = ROOT / "build" / "chip_smoke"

REL_TOL = 2e-4          # max |kernel - plain| / max |plain|: fp32 sum order
WELL_FACTOR = 1.1       # paper §4.1: within 10 % of the best
TUNE_BUDGET = 25
REPLAY_SEEDS = 100
CHECK_CONFIGS = (       # (BLOCK_M, BLOCK_N, BLOCK_K, LOOP_ORDER)
    (64, 64, 128, "mnk"),     # smallest tile
    (512, 512, 1024, "nmk"),  # largest tile
    (128, 256, 256, "nmk"),
    (256, 64, 512, "mnk"),
)
NOT_PORTED = (
    ("conv2d", "src/repro/kernels/conv2d/kernel.py:78"),
    ("transpose", "src/repro/kernels/transpose/kernel.py:37"),
    ("coulomb", "src/repro/kernels/coulomb/kernel.py:84"),
    ("nbody", "src/repro/kernels/nbody/kernel.py:72"),
    ("flash_attention", "src/repro/kernels/attention/kernel.py:105"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush=None) -> float:
    """Median of ``reps`` calls of ``fn``, each timed with CUDA events around
    the call alone, after one warm-up call; ``flush`` is zeroed before each
    call so that L2 holds none of the operands."""
    import torch

    fn()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def phase_build():
    from repro_torch.kernels import common

    for src in sorted(p.name for p in common.CSRC_DIR.glob("*.cu")):
        report = common.build(src)
        log(f"[build] {src} -> {common.library_path(src).name}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


def phase_check(bench, inputs, device):
    """Kernel against its plain version; returns (max_abs_err, max_rel)."""
    import numpy as np

    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain

    worst_abs = worst_rel = 0.0
    for tag, inp in inputs.items():
        a, b = bench.make_args(inp, np.random.default_rng(0), device)
        for bm, bn, bk, order in CHECK_CONFIGS:
            kw = dict(block_m=bm, block_n=bn, block_k=bk, loop_order=order)
            out = matmul(a, b, **kw)
            ref = matmul_plain(a, b, **kw)
            if out.shape != ref.shape or not bool(out.isfinite().all()):
                raise AssertionError(f"matmul {tag} {kw}: bad output")
            err = float((out - ref).abs().max())
            rel = err / (float(ref.abs().max()) + 1e-30)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if rel > REL_TOL:
                raise AssertionError(
                    f"matmul {tag} {kw}: rel err {rel:.3e} > {REL_TOL}")
        log(f"[check] matmul {tag}: {len(CHECK_CONFIGS)} configs within "
            f"{REL_TOL} of the plain version")
    return worst_abs, worst_rel


def phase_sweep(bench, space, inp, hw, device):
    """Measure every configuration; returns the record and its summary."""
    from repro_torch.core.evaluate import DeviceKernelEvaluator

    ev = DeviceKernelEvaluator(space, bench, inp, hw=hw, device=device)
    t0 = time.perf_counter()
    for i in range(len(space)):
        ev.profile(i)
    rec = ev.recorded()
    best, worst = int(rec.runtimes.argmin()), int(rec.runtimes.argmax())
    summary = {
        "configs": len(space), "host_s": time.perf_counter() - t0,
        "best_config": space[best], "best_ms": rec.runtimes[best] * 1e3,
        "worst_config": space[worst], "worst_ms": rec.runtimes[worst] * 1e3,
        "within_well_factor": int(rec.well_performing_mask(WELL_FACTOR).sum()),
    }
    log(f"[sweep] {inp.tag}: {summary['configs']} configs in "
        f"{summary['host_s']:.1f} s; best {space[best]} "
        f"{summary['best_ms']:.4f} ms, worst {space[worst]} "
        f"{summary['worst_ms']:.4f} ms, {summary['within_well_factor']} "
        f"within {WELL_FACTOR}x of the best")
    return rec, summary


def phase_main(bench, train_inp, tune_inp, hw, device, rec):
    """The user's path; returns (launch counts, model, summary)."""
    from repro_torch.core.evaluate import DeviceKernelEvaluator
    from repro_torch.kernels.matmul import space as gemm_space
    from repro_torch.kernels.matmul.kernel import matmul
    from repro_torch.tuning import TuningSession

    def card(inp):
        return lambda space: DeviceKernelEvaluator(space, bench, inp, hw=hw,
                                                   device=device)

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(ARTIFACT_DIR / "gemm_tppc.json")
    matmul.launches = 0
    trainer = TuningSession(
        gemm_space.make_space(train_inp),
        lambda c: bench.workload_fn(c, train_inp), hw=hw,
        evaluator_factory=card(train_inp))
    train_ev = trainer.make_evaluator()
    trainer.train_on_evaluator(train_ev)
    trainer.save_model(path)
    train_launches = matmul.launches
    tuner = TuningSession(
        bench.make_space(), lambda c: bench.workload_fn(c, tune_inp), hw=hw,
        evaluator_factory=card(tune_inp))
    model = tuner.load_model(path)
    ev = tuner.make_evaluator()
    result = tuner.tune(budget=TUNE_BUDGET, searcher="profile", evaluator=ev)
    launches = {"matmul": matmul.launches}
    well = rec.well_performing_mask(WELL_FACTOR)
    steps = next((s for s, (idx, _) in enumerate(ev.history(), 1)
                  if well[idx]), None)
    log(f"[main] trained on {train_inp.tag} with {train_ev.steps} profiled "
        f"tests in {train_ev.elapsed:.3f} s of host time; artifact {path}")
    log(f"[main] tuned {tune_inp.tag}: {result.steps} tests in "
        f"{ev.elapsed:.3f} s of host time, best {result.best_config} "
        f"{result.best_runtime * 1e3:.4f} ms; first within {WELL_FACTOR}x "
        f"of the sweep's best at step "
        f"{steps if steps is not None else f'> {TUNE_BUDGET} (not reached)'}")
    log(f"[main] launches: {launches} ({train_launches} while training)")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    summary = {
        "steps_to_well": steps,
        "train_tests": train_ev.steps, "train_host_s": train_ev.elapsed,
        "train_launches": train_launches,
        "tune_tests": ev.steps, "tune_host_s": ev.elapsed,
        "tune_launches": launches["matmul"] - train_launches,
        "tuned_config": result.best_config,
        "tuned_ms": result.best_runtime * 1e3,
    }
    return launches, model, summary


def phase_replay(rec, model, hw):
    from repro_torch.core.searcher import make_searcher
    from repro_torch.core.tuner import run_search_experiment

    out = {}
    for name in ("profile", "random"):
        stats = run_search_experiment(
            lambda seed, name=name: make_searcher(
                name, rec.space, seed=seed, model=model, cores=hw.sms),
            rec, repeats=REPLAY_SEEDS, well_factor=WELL_FACTOR)
        out[name] = {"median_trials_to_well": stats.median_steps,
                     "mean_trials_to_well": stats.mean_steps,
                     "found_rate": stats.found_rate}
        log(f"[replay] {rec.input_tag}: {stats.summary()} over "
            f"{REPLAY_SEEDS} seeds")
    return out


def kernel_times(bench, inp, rec, hw, device, flush):
    """Times of the kernel (default and best config), its plain version,
    the library call and the bound, at one input."""
    import numpy as np
    import torch

    from repro_torch.kernels.matmul.kernel import matmul_plain

    a, b = bench.make_args(inp, np.random.default_rng(0), device)
    best = rec.space[int(rec.runtimes.argmin())]
    default = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
               "LOOP_ORDER": "mnk", "ACC_F32": 1}   # the wrapper's defaults
    kw = dict(block_m=best["BLOCK_M"], block_n=best["BLOCK_N"],
              block_k=best["BLOCK_K"], loop_order=best["LOOP_ORDER"])
    run = bench.run
    ms_best = time_ms(lambda: run(best, a, b), 20, flush)
    ms_default = time_ms(lambda: run(default, a, b), 20, flush)
    plain_ms = time_ms(lambda: matmul_plain(a, b, **kw), 3, flush)
    library_ms = time_ms(lambda: torch.matmul(a, b), 20, flush)
    flops = 2.0 * inp.m * inp.n * inp.k
    nbytes = 4.0 * (inp.m * inp.k + inp.k * inp.n + inp.m * inp.n)
    t_ops, t_bytes = flops / hw.fp32_flops * 1e3, nbytes / hw.dram_bw * 1e3
    return {
        "shape": inp.tag, "best_config": best,
        "ms": ms_best, "kernel_ms_best": ms_best,
        "kernel_ms_default": ms_default, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import hwspec
    from repro_torch.device import resolve_device
    from repro_torch.kernels.matmul import space as gemm_space
    from repro_torch.kernels.registry import BENCHMARKS

    t_start = time.perf_counter()
    # phase 1: device
    device = resolve_device()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    hw = hwspec.detect()
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; spec {hw.name}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    phase_build()

    # phase 3: kernel against plain version
    bench = BENCHMARKS["matmul"]
    inputs = dict(bench.inputs)
    inputs["1000x1000x1000"] = gemm_space.GemmInput(1000, 1000, 1000)
    max_abs, max_rel = phase_check(bench, inputs, device)

    # phase 4: exhaustive sweeps
    big, tall = bench.inputs["2048"], bench.inputs["16x4096"]
    rec_big, sweep_big = phase_sweep(bench, bench.make_space(), big, hw,
                                     device)
    rec_tall, sweep_tall = phase_sweep(bench, gemm_space.make_space(tall),
                                       tall, hw, device)

    # phase 5: the main path, live
    launches, model, main_path = phase_main(bench, tall, big, hw, device,
                                            rec_big)

    # phase 6: replay on both measured records
    main_path["replay"] = {rec.input_tag: phase_replay(rec, model, hw)
                           for rec in (rec_big, rec_tall)}

    # phase 7: report
    from repro_torch.core.evaluate import L2_FLUSH_BYTES

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    entry = {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:82",
        "launches": launches["matmul"],
        "max_abs_err": max_abs, "max_rel_err": max_rel,
    }
    entry.update(kernel_times(bench, big, rec_big, hw, device, flush))
    entry["at_" + tall.tag] = kernel_times(bench, tall, rec_tall, hw, device,
                                           flush)
    entry["main_path"] = main_path
    entry["sweeps"] = {big.tag: sweep_big, tall.tag: sweep_tall}
    report = {"kernels": [entry],
              "not_ported": [{"name": n, "replaces": r}
                             for n, r in NOT_PORTED]}
    log(f"[report] total {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
