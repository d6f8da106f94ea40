#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card, for every ported kernel: matmul, transpose, conv2d, coulomb
and nbody (the paper's five benchmarks) and flash attention; then the
cross-space transfer path of the ``ConfigStore`` on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device  — the card's name, count and power limit; its hardware spec.
2. build   — every CUDA source in ``src/repro_torch/csrc``, one ``nvcc``
             each, all started together, with nvcc's register /
             shared-memory / spill report; the tensor-core (HMMA)
             instructions of each library counted with ``cuobjdump -sass``,
             none in matmul or attention failing the phase, and nbody's
             MUFU, FFMA, FMUL, FADD and LDS instructions; beside them a
             variant of ``nbody.cu`` built for 4 blocks an SM instead of 3
             (timed in phase 8); then the TF32 rate mma.sync sustains on
             the card (``csrc/mma_probe.cu``, a probe, not a port), the
             practical ceiling of both kernels.
Then, kernel by kernel (the table ``PORTS``):
3. check   — the kernel against its plain PyTorch version on the card, at
             every registry input plus a ragged one (and the extra ones),
             at the smallest and largest tiles and each value of every
             parameter that changes the code path (TF32 off); transpose
             must be exact; every kernel gives the same bits in two
             launches.  The two kernels on the tensor cores (3xTF32) also
             meet their fp32 oracle within the same tolerance; the GEMM's
             line shows one TF32 pass's error beside its own.
4. sweep   — ``DeviceKernelEvaluator`` over the whole space at the tune
             input (and at the GEMM's 16x4096x4096 and nbody's 131072
             too): the measured ground truth.
5. main    — Algorithm 1 live: ``train_on_evaluator`` on the train input,
             ``save_model``; a new session on the tune input ``load_model``
             and ``tune(budget=25, searcher="profile")`` through the card
             evaluator.  Every launch count is zeroed just before and read
             just after; the kernel of the path must have launched.
6. replay  — the paper's trials-to-well metric, profile vs random searcher,
             100 seeds each, replayed on each measured record.
7. transfer — the cross-space warm start (``phase_transfer``): a store of
             the TP→PC models phase 5 trained, a target space left out of
             it, the similarity-weighted committee of the others, replay and
             one live tune on the card; conv2d/4096, then attention.
8. report  — one JSON line with each kernel's times (best and default
             configuration, plain version, library call; for a kernel bound
             by bytes a copy_ that moves as many; for nbody the SM clock and
             power nvidia-smi reads while it runs), its bound and launches;
             beside the kernels, nbody's issue floor, nbody's variants
             (the j-split's waves, 3 or 4 blocks an SM, its second kernel
             alone) and the transfer phase's results; the card's name and
             power limit; and a last line ``{"ok": true, "device": {...}}``.

The script needs CUDA and the checkout's ``src/``; without either it exits
non-zero before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARTIFACT_DIR = ROOT / "build" / "chip_smoke"

WELL_FACTOR = 1.1       # paper §4.1: within 10 % of the best
TUNE_BUDGET = 25
REPLAY_SEEDS = 100
NOT_PORTED = ()                # every TPU kernel of the JAX package is ported
# each target's sources are every other port: for conv2d these are the
# SOURCES of the JAX package's transfer benchmark (benchmarks/bench_transfer.py)
TRANSFER_TARGETS = (("conv2d", "4096"), ("attention", "default"))
# nbody's design choices timed side by side in phase 8: the blocks an SM its
# variant build is bounded for (the port's is 3), and the waves the j-split
# aims for (the port's rule takes nbody.SPLIT_WAVES, 8)
NBODY_VARIANT_BLOCKS = 4
NBODY_WAVES = (1, 8, 32)


@dataclasses.dataclass(frozen=True)
class Port:
    """One ported kernel and how this script drives it.  Configurations are
    value tuples in the order of the space's parameters; inputs are
    (class name in the kernel's ``space`` module, fields)."""

    name: str
    replaces: str            # the TPU kernel's pallas_call, file:line
    tol: float               # max |kernel - plain| / max |plain|; 0: exact
    checks: Tuple[tuple, ...]
    ragged: Tuple[str, tuple]
    sweeps: Tuple[str, ...]  # registry inputs swept; the tune input first
    train: str               # registry input the model is trained on
    default: tuple           # the wrapper's defaults, as a configuration
    library: Optional[str]   # one PyTorch call computing the same function
    # inp -> (bytes, fp32 operations, rsqrt or exp, the operations of its
    # products that can run by 3xTF32 on the tensor cores)
    work: Callable
    input_space: bool = False      # make_space(inp): the GEMM's pruning
    plain_kw: Optional[Callable] = None  # cfg -> plain version's kwargs
    wrapper: str = ""        # the wrapper's name, if not the kernel's
    # more check inputs, as ragged; kernels on the tensor cores also meet
    # their fp32 oracle (TF32 off) within tol and must hold HMMA
    # instructions in their SASS
    extra: Tuple[Tuple[str, tuple], ...] = ()
    tensor_cores: bool = False
    # (inp, hw) -> a floor below which the kernel's own instruction stream
    # cannot go (ms), reported beside the data-sheet bound with the SM clock
    # measured while the kernel runs (the floor assumes the boost clock)
    floor: Optional[Callable] = None

    @property
    def tune(self) -> str:
        return self.sweeps[0]

    @property
    def wrapper_name(self) -> str:
        return self.wrapper or self.name


def _attention_pairs(inp) -> float:
    """(query, key) pairs the function needs: S(S+1)/2 a head when causal."""
    per_head = inp.seq * (inp.seq + 1) / 2 if inp.causal else inp.seq ** 2
    return float(inp.batch * inp.heads * per_head)


def _nbody_issue_floor(inp, hw) -> Tuple[float, str]:
    """12 fp32-pipe instructions a pair, one a lane a clock."""
    from repro_torch.kernels.nbody.kernel import (FP32_INSTRUCTIONS_PER_PAIR,
                                                  issue_floor_ms)

    return (issue_floor_ms(inp.n, hw.fp32_flops),
            f"{FP32_INSTRUCTIONS_PER_PAIR} fp32-pipe instructions a pair")


def _gemm_kw(cfg):
    return dict(block_m=cfg["BLOCK_M"], block_n=cfg["BLOCK_N"],
                block_k=cfg["BLOCK_K"], loop_order=cfg["LOOP_ORDER"])


# Checks take each kernel's smallest and largest tiles; those of the
# kernels after the GEMM also take every value of every parameter that
# changes the code path at least once.  The GEMM's take, at 16x4096x4096,
# BLOCK_K 128 and 1024 (many splits and few) and M = 16 at BLOCK_M 64; its
# extra input has rows whose K and N are not multiples of 4 (4-byte copies).
# conv2d's extra inputs have rows whose W is not a multiple of 4 (4-byte
# halo copies) and F = 7 and 1; nbody's N = 200 takes the j-split at every
# BLOCK_I.
PORTS = (
    Port("matmul", "src/repro/kernels/matmul/kernel.py:82", 2e-4,
         checks=((64, 64, 128, "mnk", 1),      # smallest tile
                 (512, 512, 1024, "nmk", 1),   # largest tile
                 (128, 256, 256, "nmk", 1),
                 (256, 64, 512, "mnk", 1)),
         ragged=("GemmInput", (1000, 1000, 1000)),
         sweeps=("2048", "16x4096"), train="16x4096",
         default=(128, 128, 128, "mnk", 1), library="torch.matmul(a, b)",
         work=lambda i: (4.0 * (i.m * i.k + i.k * i.n + i.m * i.n),
                         2.0 * i.m * i.n * i.k, 0.0, 2.0 * i.m * i.n * i.k),
         input_space=True, plain_kw=_gemm_kw,
         extra=(("GemmInput", (1001, 1003, 999)),), tensor_cores=True),
    Port("transpose", "src/repro/kernels/transpose/kernel.py:37", 0.0,
         checks=((8, 8, 0), (1024, 1024, 1), (16, 512, 1), (32, 256, 0),
                 (64, 128, 1), (128, 64, 0), (256, 32, 1), (512, 16, 0)),
         ragged=("TransposeInput", (1000, 1500)),
         sweeps=("8192",), train="8192", default=(256, 256, 1),
         library="x.t().contiguous()",
         work=lambda i: (8.0 * i.m * i.n, 0.0, 0.0, 0.0)),
    Port("conv2d", "src/repro/kernels/conv2d/kernel.py:78", 1e-3,
         checks=((8, 128, 0, 0, 1), (512, 1024, 1, 1, 4),
                 (16, 256, 1, 0, 2), (32, 512, 0, 1, 1),
                 (64, 1024, 1, 0, 1), (128, 128, 0, 1, 2),
                 (256, 256, 1, 1, 4)),
         ragged=("ConvInput", (1000, 1500, 5)),
         sweeps=("4096",), train="4096", default=(128, 256, 1, 1, 2),
         library="F.conv2d(img, flt, padding=F // 2), cuDNN TF32 off",
         work=lambda i: (4.0 * (2 * i.h * i.w + i.f * i.f),
                         2.0 * i.f * i.f * i.h * i.w, 0.0, 0.0),
         extra=(("ConvInput", (1000, 1501, 5)), ("ConvInput", (37, 301, 3)),
                ("ConvInput", (515, 700, 7)), ("ConvInput", (300, 260, 1)))),
    Port("coulomb", "src/repro/kernels/coulomb/kernel.py:84", 5e-4,
         checks=((1, 4, 64, 4, 0), (64, 8, 1024, 256, 1),
                 (2, 64, 1024, 16, 0), (4, 32, 128, 64, 1),
                 (8, 64, 256, 256, 0), (16, 16, 512, 64, 0),
                 (32, 16, 64, 4, 1), (64, 8, 128, 256, 0)),
         ragged=("CoulombInput", (100, 5000)),   # > 4096 constant atoms
         sweeps=("default",), train="small_grid",
         default=(4, 8, 128, 32, 0), library=None,
         work=lambda i: (16.0 * i.n_atoms + 4.0 * i.grid_size**3,
                         6.0 * i.grid_size**3 * i.n_atoms
                         + 5.0 * i.grid_size**2 * i.n_atoms,
                         float(i.grid_size**3 * i.n_atoms), 0.0)),
    Port("nbody", "src/repro/kernels/nbody/kernel.py:72", 1e-3,
         checks=((8, 32, 1, 0), (1024, 2048, 4, 1), (16, 64, 2, 0),
                 (32, 128, 4, 1), (64, 256, 1, 0), (128, 512, 2, 1),
                 (256, 1024, 4, 0), (512, 2048, 1, 1)),
         ragged=("NBodyInput", (10000,)),
         sweeps=("16k", "131k"), train="131k", default=(256, 256, 1, 0),
         library=None,
         work=lambda i: (32.0 * i.n, 18.0 * i.n * i.n, float(i.n * i.n),
                         0.0),
         extra=(("NBodyInput", (200,)),),
         floor=lambda i, hw: _nbody_issue_floor(i, hw)),
    Port("attention", "src/repro/kernels/attention/kernel.py:105", 2e-3,
         checks=((128, 128, 0, 1), (1024, 1024, 1, 2), (256, 512, 1, 1),
                 (512, 256, 0, 2)),
         ragged=("AttentionInput", (2, 3, 1000, 64)),
         sweeps=("default",), train="default", default=(256, 256, 1, 1),
         library="F.scaled_dot_product_attention(q, k, v, is_causal=True), "
                 "fp32",
         work=lambda i: (16.0 * i.batch * i.heads * i.seq * i.head_dim,
                         4.0 * i.head_dim * _attention_pairs(i),
                         _attention_pairs(i),
                         4.0 * i.head_dim * _attention_pairs(i)),
         wrapper="flash_attention",
         extra=(("AttentionInput", (1, 2, 777, 128)),), tensor_cores=True),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clock_under_load(fn, seconds: float = 1.0) -> Dict:
    """The SM clock (MHz) and power (W) nvidia-smi reads every 100 ms while
    ``fn`` runs back to back for ``seconds``: median and least of each."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
    rows = [[float(x) for x in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    if not rows:
        raise RuntimeError("nvidia-smi read no clock while the kernel ran")
    clocks = sorted(r[0] for r in rows)
    power = sorted(r[1] for r in rows)
    return {"sm_clock_mhz_median": clocks[len(clocks) // 2],
            "sm_clock_mhz_min": clocks[0],
            "power_w_median": power[len(power) // 2], "samples": len(rows)}


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


def _module(port: Port, part: str):
    return importlib.import_module(f"repro_torch.kernels.{port.name}.{part}")


def _wrappers():
    """The wrapper of every ported kernel (each carries ``launches``)."""
    return {p.name: getattr(_module(p, "kernel"), p.wrapper_name)
            for p in PORTS}


def _plain(port: Port):
    return getattr(_module(port, "kernel"), f"{port.wrapper_name}_plain")


def _config(bench, values) -> Dict:
    return {p.name: v for p, v in zip(bench.make_space().parameters, values)}


def _space(port: Port, bench, inp):
    return _module(port, "space").make_space(inp) if port.input_space \
        else bench.make_space()


def nbody_variant_path() -> Path:
    return ARTIFACT_DIR / f"nbody_min_blocks_{NBODY_VARIANT_BLOCKS}.so"


def build_nbody_variant() -> str:
    """``csrc/nbody.cu`` built with ``-DNBODY_MIN_BLOCKS=4``: its kernel
    bounded for 4 blocks of 256 threads an SM (64 registers a thread) where
    the port's is bounded for 3; returns nvcc's report."""
    from repro_torch.kernels import common

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [common.nvcc(), *common.NVCC_FLAGS,
         f"-DNBODY_MIN_BLOCKS={NBODY_VARIANT_BLOCKS}", "-o",
         str(nbody_variant_path()), str(common.CSRC_DIR / "nbody.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the nbody variant "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def phase_build():
    from repro_torch.kernels import common

    sources = sorted(p.name for p in common.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        variant = pool.submit(build_nbody_variant)
        reports = list(pool.map(common.build, sources))
        reports.append(variant.result())
    names = sources + [f"nbody.cu -DNBODY_MIN_BLOCKS={NBODY_VARIANT_BLOCKS}"]
    paths = [common.library_path(src) for src in sources]
    paths.append(nbody_variant_path())
    for src, path, report in zip(names, paths, reports):
        log(f"[build] {src} -> {path.name}")
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s")
    # tensor-core products in each library's SASS (HMMA: mma.sync)
    hmma = {src: common.count_sass(src, "HMMA") for src in sources}
    log(f"[build] HMMA instructions by library: {hmma}")
    for port in PORTS:
        if port.tensor_cores and hmma[f"{port.name}.cu"] == 0:
            raise AssertionError(f"{port.name}.cu holds no HMMA instruction: "
                                 "its products do not run on the tensor cores")
    # nbody's instruction mix, in the whole library and in each one-lane
    # kernel (BLOCK_I >= 128, the inner loop of 4 bodies x J_UNROLL pairs):
    # a pair is 6 FFMA, 3 FMUL, 3 FADD and one MUFU.RSQ; a denormal fix-up
    # of the rsqrt would add FMUL and FSETP
    opcodes = ("MUFU.RSQ", "MUFU", "FFMA", "FMUL", "FADD", "LDS", "FSETP")
    kernels = {"library": ""}
    kernels.update({f"J_UNROLL {u}, one lane": f"nbody_f32_kernelILi{u}ELb1E"
                    for u in (1, 2, 4)})
    nbody_sass = {name: {op: common.count_sass("nbody.cu", op, function=fn)
                         for op in opcodes}
                  for name, fn in kernels.items()}
    for name, counts in nbody_sass.items():
        log(f"[build] nbody.cu SASS instructions, {name}: {counts}")
    return hmma, nbody_sass


def _rel_err(out, ref) -> Tuple[float, float]:
    err = float((out - ref).abs().max())
    return err, err / (float(ref.abs().max()) + 1e-30)


def phase_probe(hw, device) -> Dict:
    """The TF32 rate that mma.sync sustains on this card
    (``csrc/mma_probe.cu``: 16 independent products in flight a warp, two
    8-warp blocks an SM), against the data sheet's dense rate, which only
    wgmma reaches; the median of 5 timed launches."""
    import ctypes

    import torch

    from repro_torch.kernels import common

    fn = common.entry("mma_probe.cu", "repro_mma_tf32_probe",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    blocks, iters = 2 * hw.sms, 4096
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)

    def run():
        rc = common.launch(fn, out.device, out.data_ptr(), blocks, iters)
        if rc != 0:
            raise RuntimeError(f"mma probe launch failed: CUDA error {rc}")

    ms = time_ms(run, 5)
    flops = blocks * 8 * iters * 16 * 2.0 * 16 * 8 * 8
    rate = flops / (ms * 1e-3)
    log(f"[probe] mma.sync m16n8k8 TF32: {rate / 1e12:.1f} TFLOP/s "
        f"({rate / hw.tf32_flops:.3f} of the data sheet's "
        f"{hw.tf32_flops / 1e12:.0f} dense); 3xTF32 through it "
        f"{rate / 3e12:.1f} TFLOP/s")
    return {"mma_sync_tf32_flops": rate, "ms": ms,
            "share_of_tf32_flops": rate / hw.tf32_flops}


def phase_check(port: Port, bench, device):
    """Kernel against its plain version, two launches giving the same bits,
    and, on the tensor cores, against its fp32 oracle (TF32 off).
    Returns (max_abs_err, max_rel) against the plain version and a dict of
    the oracle errors (empty for the other kernels)."""
    import numpy as np
    import torch

    plain = _plain(port)
    space_mod = _module(port, "space")
    inputs = dict(bench.inputs)
    inputs["ragged"] = getattr(space_mod, port.ragged[0])(*port.ragged[1])
    for n, (cls, fields) in enumerate(port.extra):
        inputs[f"extra{n}"] = getattr(space_mod, cls)(*fields)
    worst_abs = worst_rel = 0.0
    oracle = {"max_rel_err": 0.0, "by_input": {}}
    for tag, inp in inputs.items():
        args = bench.make_args(inp, np.random.default_rng(0), device)
        ref = None if port.plain_kw else plain(*args)
        exact = bench.ref(*args) if port.tensor_cores else None
        worst_oracle = 0.0
        for values in port.checks:
            cfg = _config(bench, values)
            out = bench.run(cfg, *args)
            if port.plain_kw:
                ref = plain(*args, **port.plain_kw(cfg))
            if out.shape != ref.shape or not bool(out.isfinite().all()):
                raise AssertionError(f"{port.name} {inp.tag} {cfg}: bad "
                                     "output")
            err, rel = _rel_err(out, ref)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if port.tol == 0.0 and not torch.equal(out, ref):
                raise AssertionError(f"{port.name} {inp.tag} {cfg}: not "
                                     f"exact (max abs err {err:.3e})")
            if rel > port.tol:
                raise AssertionError(f"{port.name} {inp.tag} {cfg}: rel err "
                                     f"{rel:.3e} > {port.tol}")
            if exact is not None:
                rel_o = _rel_err(out, exact)[1]
                worst_oracle = max(worst_oracle, rel_o)
                if rel_o > port.tol:
                    raise AssertionError(
                        f"{port.name} {inp.tag} {cfg}: rel err {rel_o:.3e} "
                        f"against the fp32 oracle > {port.tol}")
            if not torch.equal(bench.run(cfg, *args), out):
                raise AssertionError(f"{port.name} {inp.tag} {cfg}: two "
                                     "launches gave different bits")
        line = (f"[check] {port.name} {tag} ({inp.tag}): {len(port.checks)} "
                f"configs {'exact' if port.tol == 0.0 else f'within {port.tol}'}"
                f" against the plain version; the same bits in two launches")
        if exact is not None:
            entry = {"kernel_rel_err": worst_oracle}
            line += f"; against the fp32 oracle {worst_oracle:.3e}"
            if port.name == "matmul":
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    one_pass = _rel_err(torch.matmul(*args), exact)[1]
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                entry["one_pass_tf32_rel_err"] = one_pass
                line += (f"; one TF32 pass (torch.matmul, allow_tf32) "
                         f"{one_pass:.3e}")
            oracle["by_input"][inp.tag] = entry
            oracle["max_rel_err"] = max(oracle["max_rel_err"], worst_oracle)
        log(line)
        del args, ref, exact
    return worst_abs, worst_rel, oracle if port.tensor_cores else {}


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
        "input": inp.tag, "configs": len(space),
        "host_s": time.perf_counter() - t0,
        "best_config": space[best], "best_ms": rec.runtimes[best] * 1e3,
        "worst_config": space[worst], "worst_ms": rec.runtimes[worst] * 1e3,
        "within_well_factor": int(rec.well_performing_mask(WELL_FACTOR).sum()),
        # each parameter value's best configuration, in ms (None: no
        # configuration of the space takes the value)
        "best_ms_by_value": {
            p.name: {str(v): min((rt * 1e3 for c, rt in zip(space,
                                                           rec.runtimes)
                                  if c[p.name] == v), default=None)
                     for v in p.values}
            for p in space.parameters},
    }
    log(f"[sweep] {bench.name} {inp.tag}: {summary['configs']} configs in "
        f"{summary['host_s']:.1f} s; best {space[best]} "
        f"{summary['best_ms']:.4f} ms, worst {space[worst]} "
        f"{summary['worst_ms']:.4f} ms, {summary['within_well_factor']} "
        f"within {WELL_FACTOR}x of the best")
    return rec, summary


def phase_main(port: Port, bench, hw, device, rec):
    """The user's path; returns (launches of its kernel, model, summary)."""
    from repro_torch.core.evaluate import DeviceKernelEvaluator
    from repro_torch.tuning import TuningSession

    train_inp, tune_inp = bench.inputs[port.train], bench.inputs[port.tune]

    def session(inp):
        return TuningSession(
            _space(port, bench, inp), lambda c: bench.workload_fn(c, inp),
            hw=hw, evaluator_factory=lambda space: DeviceKernelEvaluator(
                space, bench, inp, hw=hw, device=device))

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(ARTIFACT_DIR / f"{port.name}_tppc.json")
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    trainer = session(train_inp)
    train_ev = trainer.make_evaluator()
    trainer.train_on_evaluator(train_ev)
    trainer.save_model(path)
    train_launches = wrappers[port.name].launches
    tuner = session(tune_inp)
    model = tuner.load_model(path)
    ev = tuner.make_evaluator()
    result = tuner.tune(budget=TUNE_BUDGET, searcher="profile", evaluator=ev)
    launches = {name: w.launches for name, w in wrappers.items()}
    well = rec.well_performing_mask(WELL_FACTOR)
    steps = next((s for s, (idx, _) in enumerate(ev.history(), 1)
                  if well[idx]), None)
    log(f"[main] {port.name}: trained on {train_inp.tag} with "
        f"{train_ev.steps} profiled tests in {train_ev.elapsed:.3f} s of "
        f"host time; artifact {path}")
    log(f"[main] {port.name}: tuned {tune_inp.tag}: {result.steps} tests in "
        f"{ev.elapsed:.3f} s of host time, best {result.best_config} "
        f"{result.best_runtime * 1e3:.4f} ms; first within {WELL_FACTOR}x "
        f"of the sweep's best at step "
        f"{steps if steps is not None else f'> {TUNE_BUDGET} (not reached)'}")
    log(f"[main] {port.name}: launches {launches} ({train_launches} while "
        f"training)")
    if launches[port.name] <= 0:
        raise AssertionError(f"{port.name} never launched on its main path: "
                             f"{launches}")
    summary = {
        "train_input": train_inp.tag, "tune_input": tune_inp.tag,
        "steps_to_well": steps,
        "train_tests": train_ev.steps, "train_host_s": train_ev.elapsed,
        "train_launches": train_launches,
        "tune_tests": ev.steps, "tune_host_s": ev.elapsed,
        "tune_launches": launches[port.name] - train_launches,
        "tuned_config": result.best_config,
        "tuned_ms": result.best_runtime * 1e3,
    }
    return launches[port.name], model, summary


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


def phase_transfer(target, sources, models, records, hw, device):
    """Cross-space transfer on the card for one held-out target space.

    The JAX package runs this path inside its fleet
    (``repro/fleet/tuner.py``, ``_load_transfer``), which the port does not
    have yet; so it goes through the store, the searcher and the session
    directly, step for step as the fleet takes them:

    1. a ``ConfigStore`` holds the TP→PC model phase 5 trained live for each
       source kernel, under (kernel, its space, its train input, this card);
    2. the target's space is signed (``SpaceSignature.from_space`` with the
       counters of one workload evaluation), and the store answers with the
       similarity-weighted committee of every compatible source
       (``load_transfer_ensemble``); its ``ensemble_runtime_scores``,
       argsorted, are the order of a ``TransferredWarmStart``;
    3. trials to within 1.1x of the best are replayed over 100 seeds on the
       target's sweep record, transferred against cold (random);
    4. one live ``TuningSession.tune`` on the card walks the transferred
       order; its launch counts are zeroed just before and read just after.

    Returns the phase's summary; raises if the transfer tier does not engage
    or the target's kernel never launches."""
    import numpy as np

    from repro_torch.core.evaluate import DeviceKernelEvaluator
    from repro_torch.core.searcher import TransferredWarmStart, make_searcher
    from repro_torch.core.tuner import (ensemble_runtime_scores,
                                        run_search_experiment)
    from repro_torch.kernels.registry import BENCHMARKS
    from repro_torch.tuning import ConfigStore, SpaceSignature, TuningSession

    kernel, bucket = target
    by_name = {p.name: p for p in PORTS}
    store = ConfigStore()
    for src in sources:
        model = models[src]
        store.save_model(model.space.name, by_name[src].train, hw.name, model,
                         model.space, kind="kernel")
    bench = BENCHMARKS[kernel]
    inp = bench.inputs[bucket]
    rec = records[kernel][bucket]
    space = rec.space
    sig = SpaceSignature.from_space(
        space, kind="kernel", counters=sorted(bench.workload_fn(space[0],
                                                                inp)))
    if store.nearest_model_key(space.name, bucket, hw.name,
                               kind="kernel") is not None:
        raise AssertionError(f"{kernel} is not held out of the store")
    ensemble, top_key, top_sim = store.load_transfer_ensemble(
        sig, bucket, hw.name, bind_space=space)
    if ensemble is None:
        raise AssertionError(f"no compatible model for {kernel}/{bucket}")
    committee = [[m.source_key, w] for m, w in ensemble.members]
    order = [int(i) for i in np.argsort(
        ensemble_runtime_scores(ensemble, space, hw), kind="stable")]
    log(f"[transfer] {kernel}/{bucket}: committee of {len(committee)}: "
        + ", ".join(f"{k} ({w:.3f})" for k, w in committee)
        + f"; top {top_key}, similarity {top_sim:.4f}")

    well = rec.well_performing_mask(WELL_FACTOR)
    replay = {}
    for name, kw in (("transferred", {"order": order}), ("cold", {})):
        searcher = "transfer_warm_start" if kw else "random"
        stats = run_search_experiment(
            lambda seed, searcher=searcher, kw=kw: make_searcher(
                searcher, space, seed=seed, **kw),
            rec, repeats=REPLAY_SEEDS, well_factor=WELL_FACTOR)
        replay[name] = {"searcher": searcher,
                        "median_trials_to_well": stats.median_steps,
                        "mean_trials_to_well": stats.mean_steps,
                        "found_rate": stats.found_rate}
        log(f"[transfer] {kernel}/{bucket} replay {name} ({searcher}): "
            f"{stats.summary()} over {REPLAY_SEEDS} seeds")
    head_rank = int(np.flatnonzero(well[order])[0]) + 1
    head = [[space[i], rec.runtimes[i] / rec.best_runtime] for i in order[:5]]
    log(f"[transfer] {kernel}/{bucket}: first configuration within "
        f"{WELL_FACTOR}x at rank {head_rank} of the transferred order; its "
        f"head, as runtime / best: "
        + "; ".join(f"{c} {r:.3f}" for c, r in head))

    session = TuningSession(space, lambda c: bench.workload_fn(c, inp), hw=hw)
    ev = DeviceKernelEvaluator(space, bench, inp, hw=hw, device=device)
    live = TransferredWarmStart(space, order=order, seed=0)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    result = session.tune(budget=TUNE_BUDGET, searcher=live, evaluator=ev)
    launches = {n: w.launches for n, w in wrappers.items()}
    if launches[kernel] <= 0:
        raise AssertionError(f"{kernel} never launched on the transfer "
                             f"path: {launches}")
    steps = next((i for i, (idx, _) in enumerate(ev.history(), 1)
                  if well[idx]), None)
    log(f"[transfer] {kernel}/{bucket} live: {result.steps} tests in "
        f"{ev.elapsed:.3f} s of host time, prior trusted: {live.trusted}; "
        f"best {result.best_config} {result.best_runtime * 1e3:.4f} ms "
        f"(sweep best {rec.best_runtime * 1e3:.4f} ms); first within "
        f"{WELL_FACTOR}x at step "
        f"{steps if steps is not None else f'> {TUNE_BUDGET} (not reached)'}"
        f"; launches {launches}")
    return {
        "target": f"{kernel}/{bucket}", "sources": list(sources),
        "committee": committee, "top_key": top_key,
        "top_similarity": top_sim,
        "first_well_rank_in_order": head_rank, "order_head": head,
        "replay": replay,
        "live": {"tests": result.steps, "host_s": ev.elapsed,
                 "trusted": live.trusted, "steps_to_well": steps,
                 "tuned_config": result.best_config,
                 "tuned_ms": result.best_runtime * 1e3,
                 "sweep_best_ms": rec.best_runtime * 1e3,
                 "launches": launches[kernel]},
    }


def phase_exact_hit(target, models, hw):
    """With the target's own model in the store, the nearest-model lookup
    answers with its exact key and the transfer tier is never consulted
    (the fleet consults it only when every exact tier misses)."""
    from repro_torch.tuning import ConfigStore, store_key

    kernel, bucket = target
    train = {p.name: p.train for p in PORTS}
    store = ConfigStore()
    for name, model in models.items():
        store.save_model(model.space.name, train[name], hw.name, model,
                         model.space, kind="kernel")
    consulted = []

    def transfer_candidates(*args, **kwargs):
        consulted.append(args)
        return []

    store.transfer_candidates = transfer_candidates
    space = models[kernel].space
    _, key = store.load_nearest_model(space.name, bucket, hw.name,
                                      bind_space=space, kind="kernel")
    want = store_key(space.name, bucket, hw.name, kind="kernel")
    log(f"[transfer] {kernel}/{bucket} exact hit: nearest {key}; transfer "
        f"tier consulted {len(consulted)} times")
    if key != want or consulted:
        raise AssertionError(f"exact hit failed: {key} (want {want}), "
                             f"transfer consulted {len(consulted)} times")
    return {"target": f"{kernel}/{bucket}", "nearest_key": key,
            "transfer_consulted": len(consulted)}


def bound(port: Port, inp, hw):
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate of their unit (hwspec, data-sheet or derived).  Products that
    can run on the tensor cores take the faster of two routes to fp32
    accuracy: the fp32 pipes, or three TF32 passes (3xTF32) at the dense
    TF32 rate."""
    nbytes, fp32, sfu, tensor = port.work(inp)
    times = {"bytes (dram_bw)": nbytes / hw.dram_bw * 1e3,
             "fp32 (fp32_flops)": fp32 / hw.fp32_flops * 1e3,
             "rsqrt or exp (sfu_ops)": sfu / hw.sfu_ops * 1e3}
    routes = dict(times)
    if tensor:
        times["3xTF32 (tf32_flops)"] = 3.0 * tensor / hw.tf32_flops * 1e3
        slower = max(("fp32 (fp32_flops)", "3xTF32 (tf32_flops)"),
                     key=times.get)
        routes = {k: v for k, v in times.items() if k != slower}
    unit = max(routes, key=routes.get)
    return {"bound_ms": times[unit],
            "bound_by": "bytes" if unit.startswith("bytes") else "operations",
            "bound_unit": unit, "bound_terms_ms": times}


def _library(port: Port):
    import torch
    import torch.nn.functional as F

    return {
        "matmul": lambda a, b: torch.matmul(a, b),
        "transpose": lambda x: x.t().contiguous(),
        "conv2d": lambda img, flt: F.conv2d(img[None, None], flt[None, None],
                                            padding=flt.shape[0] // 2),
        "attention": lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
    }.get(port.name)


def _sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (a private PyTorch call; "unknown" where it is missing)."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, True)).name
    except Exception as exc:      # noqa: BLE001 - informational only
        return f"unknown ({type(exc).__name__})"


def kernel_times(port: Port, bench, inp, rec, hw, device, flush):
    """Times of the kernel (best and default config), its plain version and
    the library call, and the bound, at one input; for a kernel bound by
    bytes, a copy_ that moves as many bytes (half read, half written) under
    the same L2 flush: the rate device memory gives a plain stream."""
    import numpy as np
    import torch

    args = bench.make_args(inp, np.random.default_rng(0), device)
    best = rec.space[int(rec.runtimes.argmin())]
    default = _config(bench, port.default)
    plain = _plain(port)
    kw = port.plain_kw(best) if port.plain_kw else {}
    run = bench.run
    ms_best = time_ms(lambda: run(best, *args), 20, flush)
    ms_default = time_ms(lambda: run(default, *args), 20, flush)
    plain_ms = time_ms(lambda: plain(*args, **kw), 3, flush)
    library = _library(port)
    library_ms = (time_ms(lambda: library(*args), 20, flush)
                  if library is not None else None)
    out = {
        "shape": inp.tag, "best_config": best,
        "ms": ms_best, "kernel_ms_best": ms_best,
        "kernel_ms_default": ms_default, "default_config": default,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": port.library or "none: no single PyTorch call "
                                        "computes this function",
    }
    if port.name == "attention":
        out["library_backend"] = _sdpa_backend(*args)
    out.update(bound(port, inp, hw))
    if port.floor is not None:
        out["under_load"] = clock_under_load(lambda: run(best, *args))
    if out["bound_by"] == "bytes":
        src = torch.empty(int(port.work(inp)[0]) // 8, dtype=torch.float32,
                          device=device)
        dst = torch.empty_like(src)
        out["copy_ms"] = time_ms(lambda: dst.copy_(src), 20, flush)
    return out


def phase_nbody_variants(records, device, flush) -> Dict:
    """nbody's design choices timed side by side at each sweep's best
    configuration (median of 20 launches, L2 flushed before each): the
    j-split aiming at each of ``NBODY_WAVES`` waves, each with the kernel
    bounded for 3 blocks an SM (the port's) and for 4
    (``build_nbody_variant``); and the split's second kernel alone at the
    rule's split count, on partial sums of the same size.  Every variant's
    output is held against the wrapper's within nbody's tolerance."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.nbody import kernel as NB
    from repro_torch.kernels.registry import BENCHMARKS

    bench = BENCHMARKS["nbody"]
    variant = ctypes.CDLL(str(nbody_variant_path())).repro_nbody_f32
    variant.argtypes, variant.restype = NB._ARGTYPES, ctypes.c_int
    entries = {3: NB._entry(), NBODY_VARIANT_BLOCKS: variant}
    sms = common.sm_count(device)
    report = {}
    for tag, rec in records.items():
        inp = bench.inputs[tag]
        cfg = rec.space[int(rec.runtimes.argmin())]
        bi, bj, unroll = cfg["BLOCK_I"], cfg["BLOCK_J"], cfg["J_UNROLL"]
        n = inp.n
        bodies = bench.make_args(inp, np.random.default_rng(0), device)[0]
        ref = NB.nbody(bodies, block_i=bi, block_j=bj, j_unroll=unroll)
        out = torch.empty_like(ref)
        row = {"config": cfg, "splits": {}, "ms": {}}
        for waves in NBODY_WAVES:
            splits = NB.split_count(n, bi, bj, sms, waves)
            row["splits"][str(waves)] = splits
            ws = (torch.empty((splits, n, 4), dtype=torch.float32,
                              device=device) if splits > 1 else None)
            for blocks, fn in entries.items():
                def run(fn=fn, ws=ws, splits=splits):
                    rc = common.launch(
                        fn, device, bodies.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), n, bi, bj,
                        unroll, splits, 1e-3)
                    if rc != 0:
                        raise RuntimeError(f"nbody variant launch failed: "
                                           f"CUDA error {rc}")

                run()
                rel = _rel_err(out, ref)[1]
                if rel > 1e-3:
                    raise AssertionError(f"nbody variant ({blocks} blocks, "
                                         f"{waves} waves): rel err {rel:.3e}")
                row["ms"][f"{blocks} blocks, {waves} waves"] = time_ms(
                    run, 20, flush)
            del ws
        splits = NB.split_count(n, bi, bj, sms)
        if splits > 1:
            partial = torch.randn((splits, n, 4), device=device)

            def run_sum():
                rc = common.launch(NB._sum_entry(), device,
                                   partial.data_ptr(), out.data_ptr(), n,
                                   splits)
                if rc != 0:
                    raise RuntimeError(f"nbody sum launch failed: CUDA "
                                       f"error {rc}")

            row["sum_splits_ms"] = time_ms(run_sum, 20, flush)
            del partial
        report[inp.tag] = row
        log(f"[variants] nbody {inp.tag} at {cfg}: splits by waves "
            f"{row['splits']}; ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
            + (f"; the split's second kernel alone "
               f"{row['sum_splits_ms']:.4f} ms at {splits} splits"
               if "sum_splits_ms" in row else ""))
    return report


def _extra_report(times: Dict, floor: Optional[Dict]) -> str:
    """The issue floor with the clock under load, and the copy yardstick,
    where a kernel has them."""
    out = ""
    if floor is not None:
        load = times["under_load"]
        out += (f", issue floor {floor['issue_floor_ms']:.4f} ms "
                f"({floor['counts']} at the boost clock; SM clock "
                f"under load {load['sm_clock_mhz_median']:.0f} MHz, least "
                f"{load['sm_clock_mhz_min']:.0f}, "
                f"{load['power_w_median']:.1f} W)")
    if "copy_ms" in times:
        out += f", copy_ of as many bytes {times['copy_ms']:.4f} ms"
    return out


def run_port(port: Port, hw, device):
    """Phases 3-6 for one kernel; returns the head and the rest of its
    report entry (the times go between them), its measured records and the
    model its main path trained."""
    import torch

    from repro_torch.kernels.registry import BENCHMARKS

    bench = BENCHMARKS[port.name]
    seconds = {}
    t0 = time.perf_counter()
    max_abs, max_rel, oracle = phase_check(port, bench, device)
    seconds["check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, sweeps = {}, {}
    for tag in port.sweeps:
        inp = bench.inputs[tag]
        records[tag], sweeps[tag] = phase_sweep(
            bench, _space(port, bench, inp), inp, hw, device)
    seconds["sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, model, main_path = phase_main(port, bench, hw, device,
                                            records[port.tune])
    seconds["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_path["replay"] = {sweeps[tag]["input"]: phase_replay(rec, model, hw)
                           for tag, rec in records.items()}
    seconds["replay"] = time.perf_counter() - t0
    log(f"[time] {port.name}: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    head = {
        "name": port.name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{port.name}.cu",
        "replaces": port.replaces, "launches": launches,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "tolerance": port.tol,
    }
    if oracle:
        head["fp32_oracle"] = oracle
    rest = {"main_path": main_path,
            "sweeps": {sweeps[t]["input"]: sweeps[t] for t in port.sweeps},
            "host_s": seconds}
    return head, rest, records, model


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
    from repro_torch.core.evaluate import L2_FLUSH_BYTES
    from repro_torch.device import resolve_device
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

    # phase 2: build, and the tensor cores' rate through mma.sync
    hmma, nbody_sass = phase_build()
    probe = phase_probe(hw, device)

    # phases 3-6, kernel by kernel
    results = [run_port(port, hw, device) for port in PORTS]
    models = {p.name: r[3] for p, r in zip(PORTS, results)}
    records = {p.name: r[2] for p, r in zip(PORTS, results)}

    # phase 7: transfer
    t0 = time.perf_counter()
    transfer = []
    for target in TRANSFER_TARGETS:
        sources = tuple(p.name for p in PORTS if p.name != target[0])
        transfer.append(phase_transfer(target, sources, models, records, hw,
                                       device))
    exact = phase_exact_hit(TRANSFER_TARGETS[0], models, hw)
    log(f"[time] transfer {time.perf_counter() - t0:.1f} s")

    # phase 8: report
    t0 = time.perf_counter()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    entries, floors, variants = [], {}, {}
    for port, (head, rest, port_records, _) in zip(PORTS, results):
        bench = BENCHMARKS[port.name]
        times = kernel_times(port, bench, bench.inputs[port.tune],
                             port_records[port.tune], hw, device, flush)
        entry = {**head, **times, **rest}
        for tag in port.sweeps[1:]:
            entry["at_" + bench.inputs[tag].tag] = kernel_times(
                port, bench, bench.inputs[tag], port_records[tag], hw,
                device, flush)
        entries.append(entry)
        floor = {}
        if port.floor is not None:
            for tag in port.sweeps:
                inp = bench.inputs[tag]
                ms, counts = port.floor(inp, hw)
                floor[inp.tag] = {"issue_floor_ms": ms, "counts": counts}
            floors[port.name] = floor
        if port.name == "nbody":
            variants = phase_nbody_variants(port_records, device, flush)
        library = times["library_ms"]
        log(f"[report] {port.name} {times['shape']}: best "
            f"{times['kernel_ms_best']:.4f} ms, default "
            f"{times['kernel_ms_default']:.4f} ms, plain "
            f"{times['plain_ms']:.4f} ms, library "
            f"{'none' if library is None else f'{library:.4f} ms'}, bound "
            f"{times['bound_ms']:.4f} ms ({times['bound_unit']})"
            + _extra_report(times, floor.get(times["shape"])))
        for tag in port.sweeps[1:]:
            at = entry["at_" + bench.inputs[tag].tag]
            log(f"[report] {port.name} {at['shape']}: best "
                f"{at['kernel_ms_best']:.4f} ms, default "
                f"{at['kernel_ms_default']:.4f} ms, plain "
                f"{at['plain_ms']:.4f} ms, bound {at['bound_ms']:.4f} ms"
                + _extra_report(at, floor.get(at["shape"])))
    report = {"kernels": entries,
              "not_ported": [{"name": n, "replaces": r}
                             for n, r in NOT_PORTED],
              "transfer": transfer, "exact_hit": exact,
              "hmma_instructions": hmma, "nbody_sass": nbody_sass,
              "mma_probe": probe, "issue_floors": floors,
              "nbody_variants": variants}
    log(f"[time] report {time.perf_counter() - t0:.1f} s")
    log(f"[report] total {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
