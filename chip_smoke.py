#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card, for every ported kernel: matmul, transpose, conv2d, coulomb
and nbody (the paper's five benchmarks) and flash attention; then the
cross-space transfer path of the ``ConfigStore``, the fleet, the tuning
service, serving, training, the sharded train step, the dry run and step
tuning on the card, and the five examples as a user runs them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device  — the card's name, count and power limit; its hardware spec.
2. build   — every CUDA source in ``src/repro_torch/csrc``, one ``nvcc``
             each, all started together, with nvcc's register /
             shared-memory / spill report; the tensor-core (HMMA)
             instructions of each library counted with ``cuobjdump -sass``,
             none in matmul or attention failing the phase, as does no
             wgmma (HGMMA) instruction in matmul, and nbody's
             MUFU, FFMA, FMUL, FADD and LDS instructions; beside them a
             variant of ``nbody.cu`` built for 4 blocks an SM instead of 3
             (timed in phase 11) and a probe of ``conv2d.cu`` with
             register-blocked taps at F = 15, built for its report; no
             kernel of attention.cu or conv2d.cu may spill; then the TF32
             rate mma.sync sustains on
             the card (``csrc/mma_probe.cu``, a probe, not a port), the
             practical ceiling of both kernels.
Then, kernel by kernel (the table ``PORTS``):
3. check   — the kernel against its plain PyTorch version on the card, at
             every registry input plus a ragged one (and the extra ones;
             attention's also at V head dims below q's, among them
             deepseek-v2-236b's prefill as phase 10 serves it),
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
8. fleet   — the fleet on the card (``phase_fleet``), through the entry
             points of ``python -m repro_torch.launch.fleet``: a
             ``SubprocessWorkerPool`` with one lane on cuda:0 and a fresh
             ``ConfigStore``; round 1, one cold job (random, budget 25) at
             each kernel's train input; round 2, one job at each swept input
             with no searcher named, warm-started from round 1's artifacts.
             It fails on an infinite best, a lane on another card, a kernel
             the lane never launched, or a round-2 job that did not
             warm-start although its space has an artifact.
9. service — the tuning service on the card (``phase_service``):
             ``python -m repro_torch.launch.daemon`` measuring on cuda:0,
             two tenants' requests (one coalesced), a store hit, a refused
             request for the other H100, a serve-kind request (priced) and
             its repeat from the store, then a SIGKILL mid-request and a
             restart with ``--recover`` that finishes it on the card, and
             a SIGTERM drain.  Each submit's time to its result, trials and
             each tenant's worker-seconds are printed.
10. serve  — serving on the card (``phase_serve``): qwen2.5-3b at full
             width and depth (bf16, random weights from a seed) serves 8
             requests in two waves of 4 through ``ServeEngine``, its
             prefill attention on the kernel (launches = 36 x prefills, the
             plain version never called); layer 0's attention inputs
             through the kernel and its plain version, and wave 1's logits
             with the model's kernel call patched to the plain version;
             gemma-2b (2 layers) and deepseek-v2-236b (1 layer) at full
             width, each layer's prefill attention on the kernel
             (deepseek-v2-236b's MLA on its (192, 128) instance, counted in
             ``split_v_launches``), layer 0 and wave 1's logits checked as
             qwen2.5-3b's and the kernel timed at layer 0's inputs
             against the bound at D + Dv; ``OnlineAutotuner`` over
             ``EngineBackend`` (tune, reuse, drift);
             ``python -m repro_torch.launch.serve``.  Then the rest
             of the model zoo at full width and depth (``phase_serve_zoo``):
             zamba2-2.7b and xlstm-125m through ``ServeEngine`` (8 requests,
             prompts a multiple of 128), seamless-m4t-large-v2 through a
             greedy loop over its prefill and decode (4 requests with 4096
             frames each); attention launches read around each prefill (9
             a zamba2 prefill, 48 a seamless one of which 24 not causal,
             none for xlstm, none in decode, the plain version never
             called), layer 0's attention inputs and the first wave's
             logits through the plain version, the kernel timed at those
             inputs, a prefill and 8 decode steps profiled an arch.
12. train  — training on the card (``phase_train``), run after phase 10
             and reported in phase 11: (a) qwen1.5-0.5b at full width and
             depth (bf16, random weights from seed 0) trains 10 steps of
             8 x 1024 tokens through ``python -m
             repro_torch.launch.supervisor``, twice at once: one run's
             trainer is SIGKILLed once step 5's checkpoint is published and
             resumes there through the supervisor, and its losses at steps
             5 and 9 must match the other run's; the loss must fall. (b)
             One step of the same model in this process: step seconds,
             tokens/s, peak memory, the card's busy share, the attention
             kernel's launches a step (forward and the remat recompute
             under "nothing_saveable") and its plain version's calls (0),
             the plain backward's share. (c) ``KernelAttention``'s output
             and q/k/v gradients against autograd through the plain model
             attention at the training shape and at every compiled head
             dim, causal and not; the kernel refusing a gradient-carrying
             input; the kernel's forward beside its bound and SDPA, and the
             backward timed. (d) One train step of every SMOKE arch on the
             card: a finite loss, every parameter with a finite gradient.
13. sharded — the sharded train step and the fleet's whole-system mode
             (``phase_sharded``), run after phase 12 and reported in phase
             11: (a) qwen1.5-0.5b at full width and depth, the training
             shape, through ``shard_train_state`` and ``make_train_step(
             mesh=...)`` on a one-rank NCCL ``DeviceMesh`` on cuda:0, 3
             timed steps after a warm-up, then the plain step from the same
             state on the same batches: seconds, tokens/s, peak memory,
             busy share and the kernel's launches a step (48 on rank 0's
             local heads, the plain version 0) of both, their losses' and
             gradient norms' relative difference, the sharded path's host
             overhead.  (b) ``python -m repro_torch.launch.fleet --system
             qwen2.5-3b`` on a subprocess lane on cuda:0: the six kernel
             jobs measured on the card, the sharding (64 devices) and serve
             jobs priced, one store; each job's trials, best and seconds.
14. dryrun — the dry run and step tuning (``phase_dryrun``), run after
             phase 15 and reported in phase 11: (a) the dry run's count of
             phase 12's step (one-rank fake mesh: flops by unit, bytes,
             kernel launches, predicted peak, the roofline at the card's
             rates) beside the same step on the card (median of 3 timed
             with CUDA events, ``max_memory_allocated``, launches, device
             time under ``torch.profiler``): the launches must be equal;
             (b) ``python -m repro_torch.launch.dryrun`` on qwen2.5-3b's
             train_4k (both meshes), prefill_32k and decode_32k,
             llama4-scout-17b-a16e's three, xlstm-125m's decode_32k and
             deepseek-v2-236b's prefill_32k and decode_32k (its train
             cell takes over 10 minutes), each a process of its own
             started at the script's start at the lowest CPU priority and
             paused while a host-bound figure of phases 9, 10, 12, 13 or
             15 is taken (they need no card): every record ok, each one's per-device peak
             against 80 GB, the embedding table's and the MoE's shares;
             (c) ``launch.tune --backend measured`` at 8 x 2048 on the card
             in this process (4 profiled training tests saved as a model, 4
             tuning tests; the kernel launched, its plain version never
             called), its best re-timed beside the default StepConfig; (d)
             ``ShardingProblem(backend="compiled")`` at three layouts in a
             spawned process beside (a) and (c).
15. examples — the port's five examples (``phase_examples``), run after
             phase 13, each as a user runs it, ``python examples/torch_<name>.py`` in a
             subprocess from the checkout's root, each to exit 0: the
             quickstart in full (train on the H100 PCIe's spec, save, load
             on the card, tune the GEMM 25 tests on the card, the best
             configuration's kernel at 256³ within 2e-4 of the fp32
             oracle), the serving autotuner's two runs (the second at 0
             live trials), qwen2.5-3b's engine at full width and depth
             (tokens/s, the attention kernel launched once a layer a
             wave), the trainer at 4 steps with a checkpoint at steps 2 and
             4, and the step tune at ``EXAMPLE_STEP_TUNE`` (started at the
             script's start beside phase 14 (b)'s cells, and paused with
             them; it needs no card); each one's key figures parsed
             from its output; and the attention kernel against its plain
             version at every shape the engine's waves and the trainer's
             step give it.
11. report — one JSON line with each kernel's times (best and default
             configuration, plain version, library call; for a kernel bound
             by bytes a copy_ that moves as many; for nbody the SM clock and
             power nvidia-smi reads while it runs), its bound and launches;
             beside the kernels, nbody's issue floor, nbody's variants
             (the j-split's waves, 3 or 4 blocks an SM, its second kernel
             alone) and the transfer phase's results, the dry run's
             (``dryrun``), the step tune's (``tune``) and the examples'
             (``examples``); the card's name
             and power limit; and a last line ``{"ok": true, "device":
             {...}}``.

The check phase also holds attention at every compiled head dim and at
padded ones, and conv2d at F = 9 and F = MAX_F with unrolled and looped
taps (the lowering above the compiled F), against their plain versions.

The script needs CUDA and the checkout's ``src/``; without either it exits
non-zero before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
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
# nbody's design choices timed side by side in phase 11: the blocks an SM its
# variant build is bounded for (the port's is 3), and the waves the j-split
# aims for (the port's rule takes nbody.SPLIT_WAVES, 8)
NBODY_VARIANT_BLOCKS = 4
NBODY_WAVES = (1, 8, 32)
CONV2D_PROBE_F = 15         # the F past conv2d's compiled unrolled taps
FLEET_DEVICE = "cuda:0"     # the fleet phase's one lane
# the service phase: tenant A's two requests (and B's coalesced one), then
# the request interrupted by a SIGKILL and resumed under --recover; that
# one's input is not one of A's, which the store would answer with 0 trials
SERVICE_REQUESTS = (("conv2d", "4096"), ("nbody", "16k"))
SERVICE_BUDGET = 12
SERVICE_RESUMED = ("nbody", "131k")
SERVICE_RESUMED_BUDGET = 25
SERVICE_FLOOR = 0.9         # a tuned runtime below 0.9x its input's best,
#                             timed beside it, would be a mis-measurement
# phase 9 also answers one serve-kind request (priced) and its repeat, as
# tests/test_service.py::test_daemon_serve_kind_submit asks it
SERVICE_SERVE = {"bucket": "p2n2", "bucket_shape": [40, 12],
                 "batch_sizes": [1, 2, 4, 8, 16], "max_seqs": [32, 64, 96, 128]}
# phase 10, serving: qwen2.5-3b at full width and depth (bf16) serves 8
# requests of 128-1024 prompt tokens and 32 new tokens, in waves of 4
SERVE_ARCH = "qwen2.5-3b"
SERVE_SEED = 0
SERVE_BATCH = 4
SERVE_MAX_SEQ = 1152
SERVE_N = 8
SERVE_PROMPT = (128, 1024)
SERVE_NEW = 32
# the model's logits through the kernel and through its plain version:
# both attentions are fp32-accurate, but their outputs are cast to bf16,
# where a last-bit difference flips a rounding (2**-8 relative) and 36
# layers carry it on; 5e-2 of the largest logit holds that and catches a
# wrong head, mask or scale (which move logits by their own size)
SERVE_LOGIT_TOL = 5e-2
# archs served at full width with their depth cut (name, layers kept): one
# wave of 4 requests of 64-256 prompt tokens and 8 new tokens each
SERVE_CUT = (("gemma-2b", 2), ("deepseek-v2-236b", 1))
SERVE_CUT_PROMPT = (64, 256)
SERVE_CUT_NEW = 8
# the online autotuner on the qwen2.5-3b params: three ticks of 8 requests
# (prompt tokens, new tokens); the third drifts to another bucket
SERVE_TICKS = ((48, 8), (48, 8), (200, 24))
SERVE_TUNE_RANGE = (256, 32)             # the bucketer's max prompt, max new
SERVE_TUNE_SPACE = {"batch_sizes": (1, 2, 4, 8),
                    "max_seqs": (64, 128, 256, 512)}
SERVE_LIVE_TRIALS = 4
# phase 10 also serves the rest of the model zoo at full width and depth
# (bf16, random weights from SERVE_SEED): zamba2-2.7b and xlstm-125m through
# ServeEngine, SERVE_N requests in waves of SERVE_BATCH, SERVE_NEW new tokens
# each.  Their chunked scans take a prompt of at most 128 tokens or a
# multiple of 128 (the JAX package asserts it, and the port refuses the
# rest: ROADMAP.md, queue 3), and the engine left-pads a wave to its longest
# prompt; so their prompt lengths are drawn from the multiples of 128 in
# SERVE_PROMPT
SERVE_RECURRENT = ("zamba2-2.7b", "xlstm-125m")
SERVE_CHUNK = 128
# seamless-m4t-large-v2 (24 + 24 layers): the engine feeds tokens only, so a
# greedy loop over Model.prefill and Model.decode with the engine's
# left-padding serves 4 requests, each with seeded frames (frontend_len,
# frontend_dim) fp32, a prompt of 16-64 tokens and 16 new tokens
SERVE_ENCDEC = "seamless-m4t-large-v2"
SERVE_ENCDEC_N = 4
SERVE_ENCDEC_PROMPT = (16, 64)
SERVE_ENCDEC_NEW = 16
SERVE_PROFILE_STEPS = 8                  # decode steps profiled an arch
# zamba2-2.7b in bf16 with random weights carries a last-bit rounding flip
# of one superblock's attention output into every later one: its bf16
# logits through the kernel lie 6.4e-2 from those through the plain version
# and 7.6e-2 from those through PyTorch's SDPA (fp32-accurate, a third
# route), and with the same weights in fp32 2.6e-5 and 2.4e-5 (NVIDIA H100
# 80GB HBM3, 700 W; this phase reports them under "fp32_check").  So its
# kernel-vs-plain logits are held in fp32, the same weights cast, within
# SERVE_FP32_LOGIT_TOL (about 40x what was measured; a wrong head, mask or
# scale moves logits by their own size); its bf16 difference is reported
# and its greedy tokens held to the margin rule
SERVE_FP32_CHECK = ("zamba2-2.7b",)
SERVE_FP32_LOGIT_TOL = 1e-3
# the head dims the check phase holds attention at beside the registry's:
# every compiled one, and padded ones between them (1 to 256)
ATTENTION_CHECK_DIMS = (16, 32, 64, 80, 128, 192, 256, 1, 48, 200)
# and the (qk, V) head dims it holds attention at with V narrower than q
# and k: every compiled split pair, one padded to it from each side, and
# one padded to a D = Dv instance
ATTENTION_SPLIT_CHECK_DIMS = ((192, 128), (192, 100), (160, 128), (64, 48))
# phase 12, training: qwen1.5-0.5b at full width and depth (bf16, random
# weights from seed 0) trains TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
# tokens through the supervisor CLI, checkpointing every TRAIN_CKPT_EVERY;
# one run's trainer is SIGKILLed once TRAIN_KILL_AT is published and resumes
# there, beside a run that is not killed
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_STEPS = 10
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_CKPT_EVERY = 5
TRAIN_KILL_AT = 5
# the resumed run's losses against the uninterrupted run's, at the steps
# both print after the kill: the restored state is the saved one bit for
# bit, but nothing promises a bitwise repeatable bf16 step on the card (the
# embedding gradient sums a token's rows in an order the library chooses;
# on an H100 the printed losses came out equal); ulp-level weight
# differences move a loss near 8-12 by about 1e-4, the lines print 4
# decimals, and a wrong restore (a step replayed or skipped) moves the loss
# by 1e-1 or more here (0.44 from step 5 to step 9), so 1e-2
TRAIN_LOSS_TOL = 1e-2
TRAIN_LOSS_STEPS = (5, 9)
# KernelAttention against autograd through the plain model attention:
# forward and q/k/v gradients, relative to the largest magnitude; the
# training shape, and a small one at every compiled head dim
TRAIN_GRAD_TOL = 1e-4
TRAIN_ATTN_SMALL = (1, 2, 256)                   # (B, H, S), then each D
TRAIN_TIMED_STEPS = 3
# one train step of every SMOKE arch on the card
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 64
# phase 13, the sharded step: TRAIN_ARCH at the training shape through
# shard_train_state / make_train_step(mesh=...) on a one-rank NCCL mesh,
# SHARDED_TIMED_STEPS after one warm-up, beside the plain step on the same
# batches from the same state; their losses and gradient norms a step
# relative to the plain step's
SHARDED_TIMED_STEPS = 3
SHARDED_TOL = 1e-3
# and the fleet's whole-system mode: every kernel measured on the lane's
# card, the sharding layout (64 devices) and the serve geometry priced
SYSTEM_ARCH = "qwen2.5-3b"
SYSTEM_BUDGET = 6
# phase 14, the dry run and step tuning: (a) the dry run's count of phase
# 12's step (TRAIN_ARCH at TRAIN_BATCH x TRAIN_SEQ, loss_chunks 1) on a
# one-rank fake mesh beside the same step on the card, timed by the
# measured step tuner's evaluator (its STEPS_TIMED after a warm-up), the
# measured peak within DRY_PEAK_BAND of the predicted one; (b) production
# cells through the dry-run CLI with --sites, each (arch, shape, --mesh) a
# process of its own, started at the script's start, DRY_SITES reported
# apart; (c) the kernel against autograd through the plain attention at
# the tune's shapes (STEP_TUNE_SEQ, each microbatch's batch), then the
# measured step tune through the tune CLI's entry point at STEP_TUNE_BATCH
# x STEP_TUNE_SEQ (every timed step's loss finite), then its best beside
# the default StepConfig; (d) ShardingProblem's compiled backend at
# SHARDING_CONFIGS (indices of its space), in a process of its own beside
# (a) and (c)
# measured / predicted peak of (a): 1.007 in every run so far (30.24 GB
# against 30.04 GB; NVIDIA H100 80GB HBM3, 700.00 W)
DRY_PEAK_BAND = (0.95, 1.05)
DRY_CELLS = (("qwen2.5-3b", "train_4k", "both"),
             ("qwen2.5-3b", "prefill_32k", "single"),
             ("qwen2.5-3b", "decode_32k", "single"),
             ("llama4-scout-17b-a16e", "train_4k", "single"),
             ("llama4-scout-17b-a16e", "prefill_32k", "single"),
             ("llama4-scout-17b-a16e", "decode_32k", "single"),
             ("xlstm-125m", "decode_32k", "single"),
             ("deepseek-v2-236b", "prefill_32k", "single"),
             ("deepseek-v2-236b", "decode_32k", "single"))
# the gathered embedding table, the MoE's capacity dispatch and the
# dropless MoE's replicated tokens
DRY_SITES = ("models/common.py:embed_lookup", "models/moe.py:moe_apply",
             "models/moe.py:moe_apply_dropless")
STEP_TUNE_ARCH = "qwen1.5-0.5b"
STEP_TUNE_BATCH, STEP_TUNE_SEQ = 8, 2048
STEP_TUNE_TRAIN_SAMPLES, STEP_TUNE_BUDGET = 4, 4
SHARDING_ARCH = "qwen2.5-3b"
SHARDING_CONFIGS = (0, 36, 67)
# phase 15, the examples: each ``examples/torch_*.py`` run as a user runs
# it, a subprocess from the checkout's root on the card; the step tune
# (the dry run's counts, no card) cut to EXAMPLE_STEP_TUNE, started at the
# script's start beside phase 14 (b)'s cells; the trainer cut to
# EXAMPLE_TRAIN
EXAMPLE_STEP_TUNE = ("--arch", "qwen1.5-0.5b", "--budget", "2",
                     "--train-samples", "2")
EXAMPLE_TRAIN = ("--steps", "4", "--ckpt-every", "2")
EXAMPLE_TIMEOUT = 600
QUICKSTART_TOL = 2e-4       # the GEMM's tolerance against its fp32 oracle


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


def _attention_work(inp) -> Tuple[float, float, float, float]:
    """Attention's work at q and k of head dim D and V of Dv: q, k, v and
    the output read or written once, 2·D a pair for QKᵀ and 2·Dv for PV."""
    d = inp.head_dim
    dv = d if inp.v_head_dim is None else inp.v_head_dim
    pairs = _attention_pairs(inp)
    return (8.0 * inp.batch * inp.heads * inp.seq * (d + dv),
            2.0 * (d + dv) * pairs, pairs, 2.0 * (d + dv) * pairs)


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
                ("ConvInput", (515, 700, 7)), ("ConvInput", (300, 260, 1)),
                # register-blocked taps at F = 9; at F = MAX_F, UNROLL_TAPS
                # = 1 lowered to the looped kernel
                ("ConvInput", (515, 700, 9)), ("ConvInput", (300, 517, 31)))),
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
         work=_attention_work, wrapper="flash_attention",
         extra=(("AttentionInput", (1, 2, 777, 128)),) + tuple(
             ("AttentionInput", (1, 4, 500, d)) for d in ATTENTION_CHECK_DIMS)
         + tuple(("AttentionInput", (1, 4, 500, d, True, 2, dv))
                 for d, dv in ATTENTION_SPLIT_CHECK_DIMS)
         # deepseek-v2-236b's MLA prefill as phase 10 serves it: its 128
         # heads at the longest prompt
         + (("AttentionInput", (SERVE_BATCH, 128, SERVE_CUT_PROMPT[1], 192,
                                True, 2, 128)),),
         tensor_cores=True),
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


# Builds beside the port's, each (source, flag, library): nbody's kernel
# bounded for 4 blocks of 256 threads an SM (64 registers a thread) where
# the port's is bounded for 3, timed in phase 11; and conv2d with
# register-blocked taps for one F past the compiled ones, built only for
# ptxas's report (where the unrolled taps start to spill).
VARIANTS = (
    ("nbody.cu", f"-DNBODY_MIN_BLOCKS={NBODY_VARIANT_BLOCKS}",
     nbody_variant_path()),
    ("conv2d.cu", f"-DREPRO_CONV2D_PROBE_F={CONV2D_PROBE_F}",
     ARTIFACT_DIR / f"conv2d_probe_f{CONV2D_PROBE_F}.so"),
)
# sources whose every compiled kernel must be free of spills: the head dims
# and filter sizes they compile were chosen for it
NO_SPILL_SOURCES = ("attention.cu", "conv2d.cu")


def build_variant(source: str, flag: str, path: Path) -> str:
    """``csrc/<source>`` built with ``flag`` into ``path``; returns nvcc's
    report."""
    from repro_torch.kernels import common

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [common.nvcc(), *common.NVCC_FLAGS, flag, "-o", str(path),
         str(common.CSRC_DIR / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {flag} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def spills(report: str) -> Dict[str, int]:
    """Spill-store bytes of each kernel in an ``-Xptxas -v`` report, by
    (mangled) kernel name."""
    out, kernel = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line and kernel is not None:
            out[kernel] = int(line.split("bytes spill stores")[0]
                              .split(",")[-1])
    return out


def phase_build():
    from repro_torch.kernels import common

    sources = sorted(p.name for p in common.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(sources) + len(VARIANTS)) as pool:
        variants = [pool.submit(build_variant, *v) for v in VARIANTS]
        reports = list(pool.map(common.build, sources))
        reports += [v.result() for v in variants]
    names = sources + [f"{src} {flag}" for src, flag, _ in VARIANTS]
    paths = [common.library_path(src) for src in sources]
    paths += [path for _, _, path in VARIANTS]
    for src, path, report in zip(names, paths, reports):
        log(f"[build] {src} -> {path.name}")
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s")
    spill = {name: sum(spills(report).values())
             for name, report in zip(names, reports)}
    log(f"[build] spill-store bytes by library: {spill}")
    for src in NO_SPILL_SOURCES:
        if spill[src]:
            raise AssertionError(f"{src} spills: "
                                 f"{spills(reports[names.index(src)])}")
    # tensor-core products in each library's SASS (HMMA: mma.sync)
    hmma = {src: common.count_sass(src, "HMMA") for src in sources}
    log(f"[build] HMMA instructions by library: {hmma}")
    for port in PORTS:
        if port.tensor_cores and hmma[f"{port.name}.cu"] == 0:
            raise AssertionError(f"{port.name}.cu holds no HMMA instruction: "
                                 "its products do not run on the tensor cores")
    # and wgmma (HGMMA) in the GEMM's 128 x 128 sub-tile
    hgmma = common.count_sass("matmul.cu", "HGMMA")
    log(f"[build] HGMMA instructions in matmul.cu: {hgmma}")
    if hgmma == 0:
        raise AssertionError("matmul.cu holds no HGMMA instruction: its "
                             "128 x 128 sub-tile does not run on wgmma")
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
    return hmma, nbody_sass, spill


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


def _warm_tier(result, own_key: str) -> str:
    """Which tier of the store's warm-start ladder a fleet job started
    from: its own key, the same bucket on other hardware, the same hardware
    on another bucket, the same space, a compatible space, or none."""
    if result.transfer_from is not None:
        return f"transfer from {result.transfer_from}"
    if not result.warm_started:
        return "cold"
    kind, space, bucket, hw = result.warm_from.split("|")
    _, _, own_bucket, own_hw = own_key.split("|")
    if result.warm_from == own_key:
        tier = "exact"
    elif bucket == own_bucket:
        tier = "same bucket, other hardware"
    elif hw == own_hw:
        tier = "same hardware, other bucket"
    else:
        tier = "same space"
    return f"{tier} ({result.warm_from})"


def phase_fleet(records, main_paths, hw, device):
    """The fleet measuring on the card, through the CLI's entry points
    (``job_from_registry(..., device=)``, ``SubprocessWorkerPool(devices=)``,
    ``FleetTuner``, ``ConfigStore``): round 1, one cold random job (budget
    25) at each kernel's train input; round 2, one job at each swept input
    with no searcher named, so that each warm-starts from round 1's
    published artifacts.  The lane is a process of its own on the card;
    this process launches nothing meanwhile (its launch counts are zeroed
    before and must still be 0 after).  Each job's trials until a test
    came within 1.1x of its input's exhaustive record (phase 4) stand
    beside the replay's medians for that record (phase 6).  Raises on an
    infinite best, a lane on another card, a kernel the lane never
    launched, or a round-2 job whose space has an artifact that did not
    warm-start."""
    import math
    import tempfile

    import torch

    from repro_torch.fleet import (FleetTuner, SubprocessWorkerPool,
                                   job_from_registry)
    from repro_torch.kernels.registry import BENCHMARKS
    from repro_torch.tuning import ConfigStore, store_key

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    card = torch.cuda.get_device_name(device)
    out = {"device": FLEET_DEVICE, "budget": TUNE_BUDGET, "rounds": []}
    with tempfile.TemporaryDirectory() as tmp:
        store = ConfigStore(str(Path(tmp) / "fleet_store.json"))
        pool = SubprocessWorkerPool(devices=[FLEET_DEVICE])
        try:
            log(f"[fleet] pool of {pool.workers} lane(s) up in "
                f"{time.perf_counter() - t0:.1f} s: {pool.lane_info()}")
            rounds = (
                ("round 1 (cold)", [(p.name, p.train, "random")
                                    for p in PORTS]),
                ("round 2 (warm)", [(p.name, tag, None) for p in PORTS
                                    for tag in p.sweeps]))
            for label, specs in rounds:
                spaces_with_models = {split[1] for split in (
                    k.split("|") for k in store.model_keys())}
                jobs = [job_from_registry(k, tag, hw, budget=TUNE_BUDGET,
                                          searcher=searcher,
                                          device=FLEET_DEVICE)
                        for k, tag, searcher in specs]
                t1 = time.perf_counter()
                report = FleetTuner(jobs, pool, store=store).run()
                seconds = time.perf_counter() - t1
                rows = []
                for (kernel, tag, _), job, r in zip(specs, jobs,
                                                    report.results):
                    bench = BENCHMARKS[kernel]
                    inp = bench.inputs[tag]
                    rec = records[kernel].get(tag)
                    well = (r.trials_to_threshold(WELL_FACTOR
                                                  * rec.best_runtime)
                            if rec is not None else None)
                    replay = main_paths[kernel]["replay"].get(inp.tag)
                    own = store_key(job.space.name, tag, job.hardware_key,
                                    kind=job.kind)
                    row = {
                        "job": r.job, "searcher": r.searcher,
                        "warm_started": r.warm_started,
                        "tier": _warm_tier(r, own), "trials": r.trials,
                        "failures": r.failures, "known_bad": r.known_bad,
                        "best_config": r.best_config,
                        "best_ms": r.best_runtime * 1e3,
                        "record_best_ms": (rec.best_runtime * 1e3
                                           if rec is not None else None),
                        "trials_to_well": well,
                        "replay_median_trials_to_well": (
                            {n: replay[n]["median_trials_to_well"]
                             for n in ("profile", "random")}
                            if replay is not None else None),
                    }
                    rows.append(row)
                    if rec is None:
                        vs = "no exhaustive record of this input"
                    else:
                        vs = (f"within {WELL_FACTOR}x of the record's "
                              f"{row['record_best_ms']:.4f} ms at trial "
                              + (str(well) if well is not None
                                 else f"> {r.trials} (not reached)")
                              + f"; replay medians profile "
                              f"{row['replay_median_trials_to_well']['profile']}"
                              f", random "
                              f"{row['replay_median_trials_to_well']['random']}")
                    log(f"[fleet] {label} {r.job}: {r.searcher}, "
                        f"{row['tier']}; {r.trials} trials, best "
                        f"{r.best_config} {row['best_ms']:.4f} ms; {vs}")
                    if not math.isfinite(r.best_runtime):
                        raise AssertionError(f"fleet job {r.job} ended with "
                                             f"an infinite best")
                    if (label.startswith("round 2")
                            and job.space.name in spaces_with_models
                            and not r.warm_started):
                        raise AssertionError(
                            f"fleet job {r.job} did not warm-start although "
                            f"its space {job.space.name} has an artifact")
                log(f"[fleet] {label}: {len(jobs)} jobs, pool clock "
                    f"{report.elapsed:.2f} s, busy {report.busy:.2f} "
                    f"worker-seconds, {report.failures} failed attempts, "
                    f"{seconds:.1f} s")
                out["rounds"].append({
                    "round": label, "jobs": rows,
                    "pool_elapsed_s": report.elapsed,
                    "busy_s": report.busy, "failures": report.failures,
                    "host_s": seconds})
            lanes = pool.lane_info()
        finally:
            pool.close()
        out["store_entries"] = len(store)
        out["store_models"] = sum(1 for _ in store.model_keys())
    asked = {p.name for p in PORTS}
    for lane in lanes:
        log(f"[fleet] lane {lane['lane']} on {lane['device']}: card "
            f"{lane['device_name']}; launches {lane['launches']}")
        if lane["device_name"] != card:
            raise AssertionError(f"the fleet lane reports card "
                                 f"{lane['device_name']!r}, not {card!r}")
        silent = sorted(k for k in asked if lane["launches"].get(k, 0) <= 0)
        if silent:
            raise AssertionError(f"the fleet lane never launched {silent}: "
                                 f"{lane['launches']}")
    parent = {name: w.launches for name, w in wrappers.items()}
    if any(parent.values()):
        raise AssertionError(f"this process launched kernels while the lane "
                             f"measured: {parent}")
    out["lanes"] = lanes
    out["seconds"] = time.perf_counter() - t0
    log(f"[time] fleet {out['seconds']:.1f} s")
    return out


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


def _sdpa_backend(q, k, v, causal: bool = True) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (a private PyTorch call; "unknown" where it is missing)."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, causal)).name
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


class _Daemon:
    """``python -m repro_torch.launch.daemon`` in a session of its own (so
    that a SIGKILL takes its lanes with it), its output read on a thread."""

    def __init__(self, args, timeout: float = 180.0):
        import threading

        env = _env()
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.daemon", *args],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.lines = []
        self.stamps = []        # seconds after the start, a line each
        up = threading.Event()

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                self.stamps.append(time.perf_counter() - t0)
                if "tuning service on" in line:
                    up.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        if not up.wait(timeout):
            self.kill()
            raise AssertionError("the daemon did not come up:\n"
                                 + "\n".join(self.lines[-40:]))
        self.up_s = time.perf_counter() - t0
        line = next(x for x in self.lines if "tuning service on" in x)
        self.address = line.split("tuning service on ")[1].split()[0]

    def startup(self) -> str:
        """The daemon's lines up to its address, each at the second after
        the start it arrived."""
        return "; ".join(f"+{t:.2f} s {x}" for t, x in zip(self.stamps,
                                                          self.lines)
                         if x.startswith("[daemon] ")
                         and "tuning service" not in x)

    def kill(self) -> None:
        """SIGKILL to the daemon's whole session, and wait for it."""
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)
        self.reader.join(timeout=30)

    def drain(self) -> int:
        """SIGTERM (the drain handler), then the exit code."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError("the daemon did not drain within 180 s")
        self.reader.join(timeout=30)
        return rc

    def lane_launches(self) -> Dict:
        """The launches of each lane, as the daemon printed them on drain."""
        import ast

        return {x.split(" on ")[0].split()[-1]:
                ast.literal_eval(x.split("launches ", 1)[1])
                for x in self.lines
                if x.startswith("[daemon] lane ") and "launches " in x}


def _pipelined(address: str, requests) -> list:
    """Send every request in one write on one connection; the responses,
    in order."""
    import socket

    from repro_torch.service import protocol

    host, port = address.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"".join(protocol.encode(r) for r in requests))
        lines = sock.makefile("rb")
        out = [protocol.decode(lines.readline()) for _ in requests]
    for resp in out:
        if not resp.get("ok"):
            raise AssertionError(f"a submit was refused: {resp}")
    return out


def _log_tenants(when: str, tenants: Dict) -> None:
    for name, ts in sorted(tenants.items()):
        log(f"[service] tenant {name} {when}: {ts['spent_s']:.4f} "
            f"worker-seconds, {ts['submitted']} submitted, "
            f"{ts['store_hits']} answered without a trial of its own")


def _await(client, pending: Dict, seconds: float = 300.0) -> Dict:
    """Poll each request id until it is done; ``pending`` maps it to the
    time it was submitted.  Returns rid -> (seconds to its result, result)."""
    done = {}
    deadline = time.perf_counter() + seconds
    while pending:
        for rid in list(pending):
            st = client.status(rid)
            if st["state"] == "done":
                done[rid] = (time.perf_counter() - pending.pop(rid),
                             client.result(rid, timeout=30))
            elif st["state"] == "cancelled":
                raise AssertionError(f"request {rid} was cancelled: {st}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"requests {sorted(pending)} not done in "
                                 f"{seconds:.0f} s")
        time.sleep(0.05)
    return done


def _service_serve_kind(client, hw: str) -> Dict:
    """One serve-kind submit (priced by the daemon, in its own process) and
    its repeat, which the store answers with 0 trials."""
    t1 = time.perf_counter()
    r = client.submit_serve("engine-1", hw, **SERVICE_SERVE)
    res = r if r["state"] == "done" else \
        client.result(r["request_id"], timeout=120)
    seconds = time.perf_counter() - t1
    need = sum(SERVICE_SERVE["bucket_shape"])
    if res["config"]["MAX_SEQ"] < need or not res["trials"]:
        raise AssertionError(f"the serve-kind request: {res}")
    t1 = time.perf_counter()
    again = client.submit_serve("engine-1", hw, **SERVICE_SERVE)
    again_s = time.perf_counter() - t1
    if again["state"] != "done" or again["trials"] != 0 \
            or again["config"] != res["config"]:
        raise AssertionError(f"the serve-kind repeat was not a store hit: "
                             f"{again}")
    log(f"[service] serve {SERVICE_SERVE['bucket']} "
        f"{SERVICE_SERVE['bucket_shape']}: {res['source']}, "
        f"{res['trials']} trials, {res['config']}, {seconds:.3f} s; repeat "
        f"{again['source']}, {again['trials']} trials, {again_s:.3f} s")
    return {"bucket": SERVICE_SERVE["bucket"], "config": res["config"],
            "trials": res["trials"], "source": res["source"],
            "priced_s": res["runtime"], "seconds_to_result": seconds,
            "repeat": {"source": again["source"], "trials": again["trials"],
                       "seconds": again_s}}


def phase_service(records, device):
    """The tuning service on the card, through its CLI and its client:
    ``python -m repro_torch.launch.daemon`` measures on cuda:0 by default
    (one subprocess lane).  Tenant A submits conv2d/4096 and nbody/16384
    (budget 12), tenant B conv2d/4096 at once, which must coalesce onto A's;
    each result must be finite and no better than 0.9x its input's best,
    the faster of the exhaustive record's best configuration (phase 4) and
    the answered one, both timed again once the daemons are gone
    (``_service_floor``); a repeat is answered from the store with 0
    trials; a request for the other H100 is refused.  Then nbody/131072
    (budget 25) starts, the daemon is SIGKILLed once ``status`` shows a
    trial, restarted with ``--recover``: the old request ids answer as
    before and the interrupted request ends with 25 trials in all, measured
    on the card; SIGTERM drains it with exit code 0.  The corpus must be
    stamped as the card's (``shards.json``'s ``provenance``).  This process launches
    nothing meanwhile; the lanes launch conv2d and nbody."""
    import math
    import tempfile

    import torch

    from repro_torch.core import hwspec
    from repro_torch.service import ServiceClient, ServiceError

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    hw = hwspec.hardware_key(hwspec.detect(0))
    other = "h100_pcie" if hw != "h100_pcie" else "h100_sxm"
    out = {"hardware": hw, "budget": SERVICE_BUDGET, "requests": []}
    floors = []     # (report row, kernel, input, result) for _service_floor
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--store-dir", str(Path(tmp) / "corpus"), "--port", "0"]
        first = _Daemon(args)
        try:
            log(f"[service] daemon up in {first.up_s:.2f} s on "
                f"{first.address}: {first.startup()}")
            # the corpus says its results are measured on the card, so no
            # priced or CPU-measured daemon answers from it
            meta = json.loads((Path(tmp) / "corpus" / "shards.json")
                              .read_text())
            if meta.get("provenance") != "card":
                raise AssertionError(f"the corpus is not stamped as the "
                                     f"card's: {meta}")
            out["corpus_provenance"] = meta["provenance"]
            a = ServiceClient(first.address, timeout=60)
            b = ServiceClient(first.address, timeout=60)
            # A's and B's identical requests in one write, answered in
            # order: B's arrives while A's is in flight and coalesces
            kernel, tag = SERVICE_REQUESTS[0]
            t1 = time.perf_counter()
            ra, r = _pipelined(first.address, [
                {"op": "submit", "kind": "kernel", "tenant": tenant,
                 "kernel": kernel, "input": tag, "hardware": hw,
                 "budget": SERVICE_BUDGET} for tenant in ("A", "B")])
            if r.get("coalesced") != ra["request_id"]:
                raise AssertionError(f"B's {kernel}/{tag} did not coalesce "
                                     f"onto A's: {ra}, {r}")
            pending = {ra["request_id"]: t1, r["request_id"]: t1}
            asked = {ra["request_id"]: ("A", kernel, tag),
                     r["request_id"]: ("B", kernel, tag)}
            for kernel, tag in SERVICE_REQUESTS[1:]:
                ra2 = a.submit_kernel("A", kernel, hw, input=tag,
                                      budget=SERVICE_BUDGET)
                pending[ra2["request_id"]] = time.perf_counter()
                asked[ra2["request_id"]] = ("A", kernel, tag)
            results = _await(a, pending)
            for rid, (seconds, res) in sorted(results.items()):
                tenant, kernel, tag = asked[rid]
                best = records[kernel][tag].best_runtime
                row = {"request_id": rid, "tenant": tenant,
                       "kernel": kernel, "input": tag,
                       "seconds_to_result": seconds, "trials": res["trials"],
                       "source": res["source"], "config": res["config"],
                       "ms": res["runtime"] * 1e3,
                       "record_best_ms": best * 1e3}
                out["requests"].append(row)
                log(f"[service] {tenant} {kernel}/{tag} ({rid}): "
                    f"{res['source']}, {res['trials']} trials, "
                    f"{row['ms']:.4f} ms (record's best {best * 1e3:.4f} "
                    f"ms), result {seconds:.2f} s after its submit")
                if not math.isfinite(res["runtime"]):
                    raise AssertionError(f"{kernel}/{tag}: {res}")
                floors.append((row, kernel, tag, res))
            coalesced = results[r["request_id"]][1]
            if coalesced["source"] != "coalesced" or coalesced["trials"]:
                raise AssertionError(f"B's request: {coalesced}")
            kernel, tag = SERVICE_REQUESTS[0]
            t1 = time.perf_counter()
            repeat = b.submit_kernel("B", kernel, hw, input=tag,
                                     budget=SERVICE_BUDGET)
            log(f"[service] repeat {kernel}/{tag}: {repeat['source']}, "
                f"{repeat['trials']} trials, "
                f"{time.perf_counter() - t1:.3f} s")
            if repeat["source"] != "store" or repeat["trials"] != 0:
                raise AssertionError(f"the repeat was not a store hit: "
                                     f"{repeat}")
            out["repeat"] = repeat
            try:
                b.submit_kernel("B", kernel, other, input=tag)
                raise AssertionError(f"a {other} request was not refused")
            except ServiceError as exc:
                if exc.code != "bad_request" or "no card of" not in str(exc):
                    raise
                log(f"[service] {other} refused: {exc}")
                out["refused"] = str(exc)
            out["serve_kind"] = _service_serve_kind(b, hw)
            st = a.stats()
            out["tenants_before_kill"] = st["tenants"]
            out["lanes_before_kill"] = st["lanes"]
            _log_tenants("before the kill", st["tenants"])
            for lane in st["lanes"]:
                log(f"[service] lane {lane['lane']} on {lane['device']} "
                    f"({lane['device_name']}): launches {lane['launches']}")
                if lane["device_name"] != torch.cuda.get_device_name(device):
                    raise AssertionError(f"the lane reports card "
                                         f"{lane['device_name']!r}")
                silent = [k for k, _ in SERVICE_REQUESTS
                          if lane["launches"].get(k, 0) <= 0]
                if silent:
                    raise AssertionError(f"the lane never launched {silent}")
            kernel, tag = SERVICE_RESUMED
            r3 = a.submit_kernel("A", kernel, hw, input=tag,
                                 budget=SERVICE_RESUMED_BUDGET)
            rid3, t3 = r3["request_id"], time.perf_counter()
            deadline = t3 + 300
            while a.status(rid3)["trials"] < 1:
                if time.perf_counter() > deadline:
                    raise AssertionError(f"{rid3} took no trial in 300 s")
                time.sleep(0.02)
            killed_at = a.status(rid3)["trials"]
        finally:
            first.kill()
        if killed_at >= SERVICE_RESUMED_BUDGET:
            raise AssertionError(f"{rid3} had finished ({killed_at} trials) "
                                 "before the kill")
        log(f"[service] SIGKILL with {rid3} at {killed_at} trial(s), "
            f"{time.perf_counter() - t3:.2f} s after its submit")
        out["killed_at_trials"] = killed_at
        second = _Daemon(args + ["--recover"])
        try:
            log(f"[service] recovered daemon up in {second.up_s:.2f} s: "
                f"{second.startup()}")
            c = ServiceClient(second.address, timeout=60)
            for rid, (_, res) in sorted(results.items()):
                again = c.result(rid, timeout=60)
                if {k: again[k] for k in ("config", "runtime", "trials")} \
                        != {k: res[k] for k in ("config", "runtime",
                                                 "trials")}:
                    raise AssertionError(f"{rid} answers otherwise after "
                                         f"recovery: {again} != {res}")
            t4 = time.perf_counter()
            res3 = c.result(rid3, timeout=300)
            st3 = c.status(rid3)
            best = records[kernel][tag].best_runtime
            log(f"[service] A {kernel}/{tag} ({rid3}) resumed: "
                f"{res3['source']}, {res3['trials']} trials in all, "
                f"{res3['runtime'] * 1e3:.4f} ms (record's best "
                f"{best * 1e3:.4f} ms), {time.perf_counter() - t4:.2f} s "
                f"after the restart came up")
            if not (st3["recovered"]
                    and res3["trials"] == SERVICE_RESUMED_BUDGET
                    and math.isfinite(res3["runtime"])):
                raise AssertionError(f"the resumed request: {res3}, {st3}")
            st = c.stats()
            out["recovery"] = st["recovery"]
            out["tenants"] = st["tenants"]
            out["resumed"] = {"request_id": rid3, "kernel": kernel,
                              "input": tag, "trials": res3["trials"],
                              "ms": res3["runtime"] * 1e3,
                              "record_best_ms": best * 1e3}
            floors.append((out["resumed"], kernel, tag, res3))
            _log_tenants("after the recovery", st["tenants"])
            rc = second.drain()
        finally:
            if second.proc.poll() is None:
                second.kill()
        drained = second.lane_launches()
        log("[service] drained: " + "; ".join(
            x for x in second.lines if x.startswith("[daemon] lane ")))
        if rc != 0:
            raise AssertionError(f"the drained daemon exited with {rc}")
        if not drained or any(v.get(kernel, 0) <= 0
                              for v in drained.values()):
            raise AssertionError(f"the recovered lane never launched "
                                 f"{kernel}: {drained}")
        out["lanes_after_recovery"] = drained
    out["daemon_up_s"] = [first.up_s, second.up_s]
    out["daemon_startup"] = [first.startup(), second.startup()]
    parent = {name: w.launches for name, w in wrappers.items()}
    if any(parent.values()):
        raise AssertionError(f"this process launched kernels while the "
                             f"daemon measured: {parent}")
    _service_floor(floors, records, device)
    out["seconds"] = time.perf_counter() - t0
    log(f"[time] service {out['seconds']:.1f} s")
    return out


def _service_floor(floors, records, device) -> None:
    """Holds each answered runtime at no less than ``SERVICE_FLOOR`` times
    its input's best, the faster of the exhaustive record's best
    configuration and the answered one, both timed now in this process as a
    lane times them.  The record's own reading is no floor: its sweep ran
    minutes earlier under a load of seconds, which a card held below its
    maximum power runs at lower clocks than a tune's scattered launches.
    Each row gains ``now_best_ms`` and ``now_answer_ms``."""
    import math

    from repro_torch.core import hwspec
    from repro_torch.core.evaluate import DeviceKernelEvaluator
    from repro_torch.kernels.registry import BENCHMARKS

    spec = hwspec.detect(0)
    for row, kernel, tag, res in floors:
        rec = records[kernel][tag]
        bench = BENCHMARKS[kernel]
        ev = DeviceKernelEvaluator(rec.space, bench, bench.inputs[tag],
                                   hw=spec, device=device)
        best_i = int(rec.runtimes.argmin())
        now_best = ev.measure(best_i)
        answer_i = rec.space.index_of(res["config"])
        now_answer = now_best if answer_i == best_i else ev.measure(answer_i)
        floor = SERVICE_FLOOR * min(now_best, now_answer)
        row["now_best_ms"], row["now_answer_ms"] = (now_best * 1e3,
                                                    now_answer * 1e3)
        log(f"[service] floor {kernel}/{tag}: answered "
            f"{res['runtime'] * 1e3:.4f} ms; timed now: the record's best "
            f"{rec.space[best_i]} {now_best * 1e3:.4f} ms (the record read "
            f"{rec.best_runtime * 1e3:.4f} ms), the answer "
            f"{now_answer * 1e3:.4f} ms")
        if not (math.isfinite(now_best) and math.isfinite(now_answer)
                and res["runtime"] >= floor):
            raise AssertionError(
                f"{kernel}/{tag}: {res['runtime']} s answered, below "
                f"{SERVICE_FLOOR}x the {min(now_best, now_answer)} s timed "
                f"now")


def _serve_requests(rng, n: int, lo: int, hi: int, new: int, vocab: int,
                    step: int = 1):
    """``n`` requests, prompt lengths drawn from the multiples of ``step``
    in [lo, hi], tokens in [1, vocab)."""
    import numpy as np

    from repro_torch.serve.engine import Request

    lens = step * rng.integers(lo // step, hi // step + 1, size=n)
    return [Request(uid=i, prompt=rng.integers(1, vocab, size=int(n_tok))
                    .astype(np.int32), max_new_tokens=new)
            for i, n_tok in enumerate(lens)]


class _WaveClock:
    """Times each wave of ``engine`` while it serves: its prefill (the
    card's queue drained at both ends), each decode step (drained at its
    end), the wave's wall clock, tokens and peak device memory.  Keeps
    the first wave's prompt tokens and logits."""

    def __init__(self, engine):
        import types

        import torch

        self.engine, self.waves, self.first = engine, [], {}
        model, sync = engine.model, torch.cuda.synchronize
        run_wave, decode = engine._run_wave, engine._decode

        def prefill(params, batch, max_seq):
            sync()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch, max_seq=max_seq)
            sync()
            self.waves[-1]["prefill_s"] = time.perf_counter() - t0
            if not self.first:
                self.first = {"tokens": batch["tokens"].clone(),
                              "logits": logits.clone()}
            return logits, cache

        def step(params, cache, batch):
            t0 = time.perf_counter()
            out = decode(params, cache, batch)
            sync()
            self.waves[-1]["decode_s"].append(time.perf_counter() - t0)
            return out

        def wave(requests):
            sync()
            torch.cuda.reset_peak_memory_stats()
            self.waves.append({"requests": len(requests), "prompt_len": max(
                len(r.prompt) for r in requests), "decode_s": []})
            t0 = time.perf_counter()
            out = run_wave(requests)
            sync()
            w = self.waves[-1]
            w["seconds"] = time.perf_counter() - t0
            w["tokens"] = sum(len(v) for v in out.values())
            w["tokens_per_s"] = w["tokens"] / w["seconds"]
            w["decode_ms_per_step"] = (1e3 * sum(w["decode_s"])
                                       / max(1, len(w["decode_s"])))
            w["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            return out

        engine.model = types.SimpleNamespace(prefill=prefill,
                                             decode=model.decode)
        engine._decode, engine._run_wave = step, wave
        self._restore = (model, decode, run_wave)

    def close(self) -> None:
        eng = self.engine
        eng.model, eng._decode, _ = self._restore
        del eng._run_wave                   # back to the class's own


def _log_waves(name: str, waves) -> None:
    for i, w in enumerate(waves, 1):
        log(f"[serve] {name} wave {i}: {w['requests']} requests, prompt "
            f"{w['prompt_len']}, prefill {w['prefill_s']:.4f} s, decode "
            f"{w['decode_ms_per_step']:.3f} ms a step ({len(w['decode_s'])} "
            f"steps), {w['tokens']} tokens in {w['seconds']:.3f} s "
            f"({w['tokens_per_s']:.1f} tokens/s), max memory "
            f"{w['max_memory_gb']:.2f} GB")


def _check_tokens(out, requests, vocab: int, name: str) -> None:
    for r in requests:
        toks = out[r.uid]
        if len(toks) != r.max_new_tokens \
                or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{name}: request {r.uid} generated {toks}")


def _serve_kernel_at(q, k, v, hw, flush, causal: bool = True) -> Dict:
    """The kernel (the wrapper's defaults, as the model calls it), its plain
    version and the library call at the inputs serving gave it, and the
    bound there."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as K
    from repro_torch.kernels.attention.space import AttentionInput

    port = next(p for p in PORTS if p.name == "attention")
    b, h, s, d = q.shape
    inp = AttentionInput(batch=b, heads=h, seq=s, head_dim=d, causal=causal,
                         v_head_dim=None if v.shape[3] == d else v.shape[3])
    out = {"shape": inp.tag, "causal": causal,
           "ms": time_ms(lambda: K.flash_attention(q, k, v, causal=causal),
                         20, flush),
           "plain_ms": time_ms(lambda: K.flash_attention_plain(
               q, k, v, causal=causal), 3, flush),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=causal), 20, flush),
           "library_backend": _sdpa_backend(q, k, v, causal)}
    out.update(bound(port, inp, hw))
    return out


def _busy_share(fn) -> Dict:
    """``fn`` run under ``torch.profiler``: its wall seconds, the seconds
    the card spent in kernels (the sum of their device times, overlaps
    counted twice) and the share of the wall those take; the kernels that
    took the most.  "not measured" where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []      # the kernels themselves, not the host ops that ran them
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    device_s = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    return {"wall_s": wall,
            "device_s": device_s if rows else "not measured",
            "busy_share": device_s / wall if rows else "not measured",
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:8]]}


class _AttentionRoute:
    """While open, the model's attention calls go to ``route`` (default:
    the kernel's wrapper) and are tallied by their mask; the kernel's
    plain version is counted wherever it is called.  The launches
    themselves are the wrapper's own count."""

    def __init__(self, route=None):
        import repro_torch.models.attention as A
        from repro_torch.kernels.attention import kernel as K

        self.A, self.K = A, K
        self.plain, self.route = K.flash_attention_plain, route
        self.masks = {True: 0, False: 0}
        self.plain_calls = 0

    def __enter__(self):
        K, route = self.K, self.route or self.K.flash_attention

        def counted_plain(*a, **kw):
            self.plain_calls += 1
            return self.plain(*a, **kw)

        def tallied(q, k, v, causal=True, **kw):
            self.masks[causal] += 1
            return route(q, k, v, causal=causal, **kw)

        K.flash_attention_plain = counted_plain
        self.A.flash_attention = tallied
        return self

    def __exit__(self, *exc):
        self.K.flash_attention_plain = self.plain
        self.A.flash_attention = self.K.flash_attention


def _expected_launches(cfg) -> Tuple[int, int]:
    """Attention kernel launches a prefill of a zoo arch, (causal, not):
    Zamba2's shared block once a superblock, the encoder-decoder's two
    self-attentions once a layer each, none in xLSTM."""
    if cfg.mamba_per_attn:
        return cfg.n_layers // cfg.mamba_per_attn, 0
    if cfg.enc_layers:
        return cfg.dec_layers, cfg.enc_layers
    return 0, 0


def _plain_route_check(prefill, first, attn_tol, logit_tol: Optional[float]
                       ) -> Tuple[Dict, Dict, tuple]:
    """``prefill`` (the first wave's batch, through the model) once more
    with the model's kernel call routed to the plain version: layer 0's
    attention inputs through the kernel against the plain version, and the
    wave's last logits against the kernel route's (``first["logits"]``).
    Raises past attention's tolerance, past ``logit_tol`` (None: the
    difference is reported, not held), or where a greedy token differs
    with a top-2 margin above twice the logits' difference.  Returns
    (layer 0, logits, layer 0's (q, k, v, causal)), the last None for a
    model without attention."""
    from repro_torch.kernels.attention import kernel as K

    captured = {}
    plain = K.flash_attention_plain

    def plain_route(q, k, v, causal=True):
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(),
                            causal=causal)
        return plain(q, k, v, causal=causal)

    with _AttentionRoute(plain_route):
        logits_plain = prefill()
    layer0, qkv = None, None
    if captured:
        q, k, v, causal = (captured[n] for n in ("q", "k", "v", "causal"))
        ref = plain(q, k, v, causal=causal)
        got = K.flash_attention(q, k, v, causal=causal)
        layer0 = {"shape": list(q.shape), "causal": causal,
                  "max_abs_err": float((got - ref).abs().max()),
                  "max_rel_err": float((got - ref).abs().max()
                                       / ref.abs().max()),
                  "tolerance": attn_tol}
        if layer0["max_rel_err"] > attn_tol:
            raise AssertionError(f"layer 0 attention: {layer0}")
        qkv = (q, k, v, causal)
    lk, lp = first["logits"][:, -1].float(), logits_plain[:, -1].float()
    diff = float((lk - lp).abs().max())
    top2 = lp.topk(2, dim=-1).values
    agree = (lk.argmax(-1) == lp.argmax(-1)).tolist()
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    logits = {"max_abs_diff": diff,
              "max_rel_diff": diff / float(lp.abs().max()),
              "tolerance": logit_tol, "first_tokens_agree": agree,
              "top2_margins": margins}
    if (logit_tol is not None and logits["max_rel_diff"] > logit_tol) or any(
            not ok and m > 2 * diff for ok, m in zip(agree, margins)):
        raise AssertionError(f"wave 1 logits: {logits}")
    return layer0, logits, qkv


def _sdpa_route(q, k, v, causal=True, **kw):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=causal)


def _fp32_route_check(name: str, model, params, first, attn_tol) -> Dict:
    """The first wave's prefill with the same weights cast to fp32, through
    the kernel and through the plain version: ``_plain_route_check`` held
    to ``SERVE_FP32_LOGIT_TOL``.  Beside it, reported: the kernel route's
    logits against a third fp32-accurate attention (PyTorch's SDPA) in
    bf16 and in fp32, the spread any two such routes show."""
    import copy

    import torch

    from repro_torch.models.registry import build_model

    def spread(prefill, logits) -> float:
        with _AttentionRoute(_sdpa_route):
            other = prefill()[:, -1].float()
        return float((logits[:, -1].float() - other).abs().max()
                     / other.abs().max())

    tokens = {"tokens": first["tokens"]}
    out = {"bf16_kernel_vs_sdpa": spread(
        lambda: model.prefill(params, tokens, SERVE_MAX_SEQ)[0],
        first["logits"])}
    model32 = build_model(model.cfg.scaled(dtype="float32"))
    params32 = copy.deepcopy(params).float()
    prefill = lambda: model32.prefill(           # noqa: E731
        params32, tokens, SERVE_MAX_SEQ)[0]
    first32 = {"logits": prefill()}
    out["layer0"], out["logits"], _ = _plain_route_check(
        prefill, first32, attn_tol, SERVE_FP32_LOGIT_TOL)
    out["fp32_kernel_vs_sdpa"] = spread(prefill, first32["logits"])
    _log_checks(f"{name} in fp32", out["layer0"], out["logits"])
    log(f"[serve] {name}: logits through the kernel against SDPA (fp32, a "
        f"third route): bf16 {out['bf16_kernel_vs_sdpa']:.4e}, fp32 "
        f"{out['fp32_kernel_vs_sdpa']:.4e}")
    del params32, first32
    torch.cuda.empty_cache()
    return out


def _log_checks(name: str, layer0, logits) -> None:
    head = (f"layer 0 attention {tuple(layer0['shape'])} "
            f"({'causal' if layer0['causal'] else 'not causal'}): kernel vs "
            f"plain max abs {layer0['max_abs_err']:.3e}, rel "
            f"{layer0['max_rel_err']:.3e} (tolerance {layer0['tolerance']});"
            if layer0 else "no attention;")
    log(f"[serve] {name}: {head} wave 1 logits through the plain version: "
        f"max abs diff {logits['max_abs_diff']:.4e}, rel "
        f"{logits['max_rel_diff']:.4e} (tolerance "
        f"{logits['tolerance'] or 'none: reported'}); "
        f"greedy first tokens agree {logits['first_tokens_agree']} (top-2 "
        f"margins {['%.4f' % m for m in logits['top2_margins']]})")


def _profile(name: str, prefill, decode_step) -> Dict:
    """One prefill, then ``SERVE_PROFILE_STEPS`` greedy decode steps, each
    under ``torch.profiler`` (``_busy_share``)."""
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill()

    def run_decode():
        tok = state["logits"][:, -1].argmax(-1)
        for _ in range(SERVE_PROFILE_STEPS):
            logits, state["cache"] = decode_step(state["cache"], tok[:, None])
            tok = logits[:, -1].argmax(-1)
            tok.tolist()                      # the engine's host read
    profiles = {"prefill": _busy_share(run_prefill),
                f"decode_{SERVE_PROFILE_STEPS}_steps": _busy_share(run_decode)}
    for what, pr in profiles.items():
        share = pr["busy_share"]
        log(f"[serve] {name} profile {what}: wall {pr['wall_s']:.4f} s, card "
            "busy " + (f"{pr['device_s']:.4f} s ({share:.1%})"
                       if not isinstance(share, str) else share)
            + f", {pr['launches']} kernels; top: " + "; ".join(
                f"{t['kernel']} {t['ms']:.3f} ms x{t['count']}"
                for t in pr["top"][:4]))
    return profiles


def phase_serve(hw, device) -> Dict:
    """Serving on the card, through ``ServeEngine``, ``OnlineAutotuner``
    and ``python -m repro_torch.launch.serve``.  Raises when a wave
    generates a token out of range, the attention kernel's launches are not
    36 x the prefill calls (or the plain version runs), the kernel and its
    plain version disagree beyond 2e-3 at layer 0's inputs or the logits
    beyond ``SERVE_LOGIT_TOL``, a cut arch fails to serve, the tuner does
    not tune, reuse and retune, or the CLI fails."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.evaluate import L2_FLUSH_BYTES
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.models.registry import build_model
    from repro_torch.serve.autotune import (EngineBackend, OnlineAutotuner,
                                            ShapeBucketer, serve_space,
                                            stats_from_model)
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tuning.store import ConfigStore

    t_phase = time.perf_counter()
    out: Dict = {"arch": SERVE_ARCH}
    attn_tol = next(p.tol for p in PORTS if p.name == "attention")
    cfg = ARCHS[SERVE_ARCH]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device)
                        .manual_seed(SERVE_SEED), device=device)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = model.param_count()
    log(f"[serve] {SERVE_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.eff_head_dim}, {out['params'] / 1e9:.3f} B parameters "
        f"({cfg.dtype}) drawn in {out['init_s']:.2f} s")
    engine = ServeEngine(model, batch_size=SERVE_BATCH,
                         max_seq=SERVE_MAX_SEQ, params=params, device=device)
    engine.warmup()
    reqs = _serve_requests(np.random.default_rng(SERVE_SEED), SERVE_N,
                           *SERVE_PROMPT, SERVE_NEW, cfg.vocab_size)

    # 1. the main path: launches zeroed just before, read just after; the
    # plain version counted wherever it is called
    clock = _WaveClock(engine)
    K.flash_attention.launches = 0
    t0 = time.perf_counter()
    try:
        with _AttentionRoute() as route:
            served = engine.generate(reqs)
    finally:
        clock.close()
    plain_calls = route.plain_calls
    launches = K.flash_attention.launches
    out["seconds"] = time.perf_counter() - t0
    _log_waves(SERVE_ARCH, clock.waves)
    _check_tokens(served, reqs, cfg.padded_vocab, SERVE_ARCH)
    n_tokens = sum(len(v) for v in served.values())
    prefills = len(clock.waves)
    log(f"[serve] {SERVE_ARCH}: {len(reqs)} requests, {n_tokens} tokens in "
        f"{out['seconds']:.3f} s ({n_tokens / out['seconds']:.1f} tokens/s);"
        f" attention kernel launches {launches} for {prefills} prefills of "
        f"{cfg.n_layers} layers; plain version called {plain_calls} times")
    if launches != cfg.n_layers * prefills or plain_calls:
        raise AssertionError(f"attention: {launches} launches for "
                             f"{prefills} prefills, {plain_calls} plain "
                             "calls")
    out.update(waves=clock.waves, tokens=n_tokens, launches=launches,
               plain_calls=plain_calls, prefills=prefills)

    # 2. wave 1's prefill with the model's kernel call routed to the plain
    # version: layer 0's attention inputs through both, and the logits;
    # the kernel timed at those inputs; wave 1's prefill and 8 decode steps
    # profiled
    first = clock.first
    before = K.flash_attention.launches
    layer0, logits, qkv = _plain_route_check(
        lambda: model.prefill(params, {"tokens": first["tokens"]},
                              SERVE_MAX_SEQ)[0], first, attn_tol,
        SERVE_LOGIT_TOL)
    _log_checks(SERVE_ARCH, layer0, logits)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    timing = _serve_kernel_at(*qkv[:3], hw, flush)
    out["profile"] = _profile(
        SERVE_ARCH, lambda: model.prefill(params, {"tokens": first["tokens"]},
                                          SERVE_MAX_SEQ),
        lambda cache, tok: model.decode(params, cache, {"tokens": tok}))
    K.flash_attention.launches = before        # comparisons do not count
    log(f"[serve] attention at {timing['shape']}: kernel {timing['ms']:.4f}"
        f" ms, plain {timing['plain_ms']:.4f} ms, library "
        f"{timing['library_ms']:.4f} ms ({timing['library_backend']}), bound"
        f" {timing['bound_ms']:.4f} ms ({timing['bound_unit']})")
    out.update(layer0=layer0, logits=logits, attention_at_serve=timing)
    del flush, qkv, first, clock
    torch.cuda.empty_cache()

    # 3. full width, depth cut
    out["reduced"] = []
    for name, layers in SERVE_CUT:
        full = ARCHS[name]
        ccfg = full.scaled(n_layers=layers)
        cmodel = build_model(ccfg)
        t0 = time.perf_counter()
        cparams = cmodel.init(torch.Generator(device=device)
                              .manual_seed(SERVE_SEED), device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ceng = ServeEngine(cmodel, batch_size=SERVE_BATCH,
                           max_seq=SERVE_CUT_PROMPT[1] + SERVE_CUT_NEW,
                           params=cparams, device=device)
        ceng.warmup()
        creqs = _serve_requests(np.random.default_rng(SERVE_SEED),
                                SERVE_BATCH, *SERVE_CUT_PROMPT,
                                SERVE_CUT_NEW, ccfg.vocab_size)
        cclock = _WaveClock(ceng)
        K.flash_attention.launches = 0
        K.flash_attention.split_v_launches = 0
        try:
            with _AttentionRoute() as route:
                cout = ceng.generate(creqs)
        finally:
            cclock.close()
        claunch = K.flash_attention.launches
        csplit = K.flash_attention.split_v_launches
        _log_waves(f"{name} ({layers} of {full.n_layers} layers)",
                   cclock.waves)
        _check_tokens(cout, creqs, ccfg.padded_vocab, name)
        expect = layers * len(cclock.waves)
        if (claunch != expect or route.plain_calls
                or csplit != (expect if ccfg.kv_lora_rank else 0)):
            raise AssertionError(f"{name}: {claunch} attention launches "
                                 f"({csplit} split-V), {expect} expected; "
                                 f"{route.plain_calls} plain calls")
        # wave 1's prefill through the plain version too, and the kernel
        # timed at layer 0's inputs (an MLA arch's on its split instance)
        cfirst = cclock.first
        clayer0, clogits, cqkv = _plain_route_check(
            lambda: cmodel.prefill(cparams, {"tokens": cfirst["tokens"]},
                                   SERVE_CUT_PROMPT[1] + SERVE_CUT_NEW)[0],
            cfirst, attn_tol, SERVE_LOGIT_TOL)
        _log_checks(name, clayer0, clogits)
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=device)
        ctiming = _serve_kernel_at(*cqkv[:3], hw, flush)
        row = {"arch": name, "reduced": f"n_layers {full.n_layers} -> "
                                        f"{layers}",
               "params": cmodel.param_count(), "init_s": init_s,
               "attention": "kernel", "launches": claunch,
               "split_v_launches": csplit, "waves": cclock.waves,
               "layer0": clayer0, "logits": clogits,
               "attention_at_serve": ctiming}
        log(f"[serve] {name}: reduced {row['reduced']}, "
            f"{row['params'] / 1e9:.3f} B parameters drawn in {init_s:.2f} "
            f"s, attention {row['attention']}, {claunch} kernel launches "
            f"({csplit} on a split-V instance); at {ctiming['shape']}: "
            f"kernel {ctiming['ms']:.4f} ms, plain {ctiming['plain_ms']:.4f}"
            f" ms, bound {ctiming['bound_ms']:.4f} ms "
            f"({ctiming['bound_unit']})")
        out["reduced"].append(row)
        del cparams, ceng, cclock, cmodel, cfirst, cqkv, flush
        torch.cuda.empty_cache()
    out["launches_total"] = launches + sum(r["launches"]
                                           for r in out["reduced"])

    # 4. the online autotuner on the same params
    ticks = []
    with tempfile.TemporaryDirectory() as tmp:
        backend = EngineBackend(model, params=params, device=device)
        tuner = OnlineAutotuner(
            backend, store=ConfigStore(os.path.join(tmp, "store.json")),
            bucketer=ShapeBucketer(*SERVE_TUNE_RANGE),
            space=serve_space(**SERVE_TUNE_SPACE),
            stats=stats_from_model(model), hw=hw,
            max_live_trials=SERVE_LIVE_TRIALS, window=SERVE_N)
        for i, (plen, new) in enumerate(SERVE_TICKS):
            treqs = _serve_requests(np.random.default_rng(SERVE_SEED + i),
                                    SERVE_N, plen, plen, new, cfg.vocab_size)
            t0 = time.perf_counter()
            tout, rep = tuner.serve(treqs)
            seconds = time.perf_counter() - t0
            _check_tokens(tout, treqs, cfg.padded_vocab, f"tick {i + 1}")
            ticks.append({"bucket": rep.bucket, "drift": rep.drift,
                          "reused": rep.reused,
                          "live_trials": rep.live_trials,
                          "config": rep.config, "seconds": seconds,
                          "history": [list(h) for h in rep.history]})
            log(f"[serve] autotuner tick {i + 1} ({SERVE_N} requests, prompt"
                f" {plen}, {new} new): bucket {rep.bucket}, drift "
                f"{rep.drift}, live trials {rep.live_trials}, config "
                f"{rep.config}, {seconds:.3f} s")
    t1, t2, t3 = ticks
    if not (t1["drift"] and 0 < t1["live_trials"] <= SERVE_LIVE_TRIALS
            and not t2["drift"] and t2["live_trials"] == 0
            and t2["config"] == t1["config"] and t3["drift"]
            and t3["bucket"] != t1["bucket"] and t3["live_trials"] > 0):
        raise AssertionError(f"the online autotuner's ticks: {ticks}")
    out["autotuner"] = {"hardware": tuner.hardware_name, "ticks": ticks}
    del backend, tuner, engine, params
    torch.cuda.empty_cache()

    # 5. the CLI
    env = _env()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         SERVE_ARCH, "--requests", str(SERVE_N)], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    line = next((x for x in cli.stdout.splitlines()
                 if x.startswith(f"[serve] {SERVE_ARCH} on cuda")), None)
    log(f"[serve] CLI exit {cli.returncode} in {cli_s:.1f} s: {line}")
    if cli.returncode != 0 or line is None:
        raise AssertionError(f"the serve CLI: exit {cli.returncode}\n"
                             f"{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
    out["cli"] = {"seconds": cli_s, "line": line}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[time] serve {out['phase_s']:.1f} s")
    return out


def _serve_engine_arch(name: str, hw, device, flush, attn_tol) -> Dict:
    """One zoo arch at full width and depth through ``ServeEngine``:
    ``SERVE_N`` requests of prompts a multiple of ``SERVE_CHUNK``, the
    launches read around each prefill, the plain-route checks, the kernel
    at layer 0's shape, the profile."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = ARCHS[name]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device)
                        .manual_seed(SERVE_SEED), device=device)
    torch.cuda.synchronize()
    row = {"arch": name, "reduced": "nothing", "params": model.param_count(),
           "init_s": time.perf_counter() - t0}
    log(f"[serve] {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{row['params'] / 1e9:.3f} B parameters ({cfg.dtype}) drawn in "
        f"{row['init_s']:.2f} s")
    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                         params=params, device=device)
    engine.warmup()
    reqs = _serve_requests(np.random.default_rng(SERVE_SEED), SERVE_N,
                           *SERVE_PROMPT, SERVE_NEW, cfg.vocab_size,
                           step=SERVE_CHUNK)

    # the main path: launches zeroed just before each prefill and read just
    # after; none may come from a decode step
    counts, decode_launches = [], [0]

    def prefill(params_, batch, max_seq):
        K.flash_attention.launches = 0
        out = model.prefill(params_, batch, max_seq=max_seq)
        counts.append(K.flash_attention.launches)
        return out

    def decode(params_, cache, batch):
        before = K.flash_attention.launches
        out = model.decode(params_, cache, batch)
        decode_launches[0] += K.flash_attention.launches - before
        return out

    engine.model = types.SimpleNamespace(prefill=prefill, decode=decode)
    engine._decode = decode
    clock = _WaveClock(engine)
    t0 = time.perf_counter()
    try:
        with _AttentionRoute() as route:
            served = engine.generate(reqs)
    finally:
        clock.close()
    row["seconds"] = time.perf_counter() - t0
    _log_waves(name, clock.waves)
    _check_tokens(served, reqs, cfg.padded_vocab, name)
    n_tokens = sum(len(v) for v in served.values())
    causal, full = _expected_launches(cfg)
    log(f"[serve] {name}: {len(reqs)} requests, {n_tokens} tokens in "
        f"{row['seconds']:.3f} s ({n_tokens / row['seconds']:.1f} tokens/s);"
        f" attention kernel launches a prefill {counts} ({causal + full} "
        f"expected), in decode {decode_launches[0]}; plain version called "
        f"{route.plain_calls} times")
    if (counts != [causal + full] * len(clock.waves) or decode_launches[0]
            or route.plain_calls or route.masks[False] != full * len(counts)):
        raise AssertionError(f"{name}: launches {counts} a prefill, "
                             f"{decode_launches[0]} in decode, masks "
                             f"{route.masks}, {route.plain_calls} plain calls")
    row.update(waves=clock.waves, tokens=n_tokens, launches=sum(counts),
               launches_a_prefill=counts, plain_calls=route.plain_calls)

    first = clock.first
    before = K.flash_attention.launches
    fp32 = name in SERVE_FP32_CHECK
    row["layer0"], row["logits"], qkv = _plain_route_check(
        lambda: model.prefill(params, {"tokens": first["tokens"]},
                              SERVE_MAX_SEQ)[0], first, attn_tol,
        None if fp32 else SERVE_LOGIT_TOL)
    _log_checks(name, row["layer0"], row["logits"])
    if fp32:
        row["fp32_check"] = _fp32_route_check(name, model, params, first,
                                              attn_tol)
    if qkv is not None:
        row["attention"] = _serve_kernel_at(*qkv[:3], hw, flush, qkv[3])
    row["profile"] = _profile(
        name, lambda: model.prefill(params, {"tokens": first["tokens"]},
                                    SERVE_MAX_SEQ),
        lambda cache, tok: model.decode(params, cache, {"tokens": tok}))
    K.flash_attention.launches = before        # comparisons do not count
    del engine, params, clock, first, qkv
    torch.cuda.empty_cache()
    return row


def _serve_encdec(hw, device, flush, attn_tol) -> Dict:
    """seamless-m4t-large-v2 at full width and depth: a greedy loop over
    ``Model.prefill`` and ``Model.decode`` with the engine's left-padding,
    seeded frames a request; as ``_serve_engine_arch`` otherwise."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import synchronize

    name = SERVE_ENCDEC
    cfg = ARCHS[name]
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = model.init(gen, device=device)
    frames = torch.randn((SERVE_ENCDEC_N, cfg.frontend_len, cfg.frontend_dim),
                         generator=gen, device=device)
    torch.cuda.synchronize()
    row = {"arch": name, "reduced": "nothing", "params": model.param_count(),
           "init_s": time.perf_counter() - t0,
           "frames": list(frames.shape)}
    log(f"[serve] {name}: {cfg.enc_layers} + {cfg.dec_layers} layers, "
        f"d_model {cfg.d_model}, {row['params'] / 1e9:.3f} B parameters "
        f"({cfg.dtype}) and frames {tuple(frames.shape)} fp32 drawn in "
        f"{row['init_s']:.2f} s")
    reqs = _serve_requests(np.random.default_rng(SERVE_SEED), SERVE_ENCDEC_N,
                           *SERVE_ENCDEC_PROMPT, SERVE_ENCDEC_NEW,
                           cfg.vocab_size)
    plen = max(len(r.prompt) for r in reqs)
    max_seq = plen + SERVE_ENCDEC_NEW
    toks = np.zeros((len(reqs), plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt      # the engine's left-pad
    batch = {"tokens": torch.from_numpy(toks).to(device), "frames": frames}

    def serve() -> Tuple[Dict, Dict]:
        """One wave, the engine's greedy loop, timed as ``_WaveClock``."""
        wave = {"requests": len(reqs), "prompt_len": plen, "decode_s": []}
        gen_toks = [[] for _ in reqs]
        synchronize(device)
        torch.cuda.reset_peak_memory_stats()
        t_wave = time.perf_counter()
        K.flash_attention.launches = 0
        logits, cache = model.prefill(params, batch, max_seq)
        synchronize(device)
        wave["prefill_s"] = time.perf_counter() - t_wave
        wave["launches"] = K.flash_attention.launches
        first = {"logits": logits.clone()}
        tok = logits[:, -1].argmax(-1)
        for step in range(SERVE_ENCDEC_NEW):
            for i, t in enumerate(tok.tolist()):
                gen_toks[i].append(int(t))
            if step == SERVE_ENCDEC_NEW - 1:
                break
            t0 = time.perf_counter()
            logits, cache = model.decode(params, cache,
                                         {"tokens": tok[:, None]})
            tok = logits[:, -1].argmax(-1)
            synchronize(device)
            wave["decode_s"].append(time.perf_counter() - t0)
        wave["seconds"] = time.perf_counter() - t_wave
        wave["decode_launches"] = K.flash_attention.launches \
            - wave["launches"]
        wave["tokens"] = sum(len(g) for g in gen_toks)
        wave["tokens_per_s"] = wave["tokens"] / wave["seconds"]
        wave["decode_ms_per_step"] = (1e3 * sum(wave["decode_s"])
                                      / max(1, len(wave["decode_s"])))
        wave["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return wave, {"logits": first["logits"], "tokens": gen_toks}

    serve()                                       # untimed warm-up wave
    with _AttentionRoute() as route:
        wave, first = serve()
    _log_waves(name, [wave])
    _check_tokens({r.uid: first["tokens"][i] for i, r in enumerate(reqs)},
                  reqs, cfg.padded_vocab, name)
    causal, full = _expected_launches(cfg)
    log(f"[serve] {name}: attention kernel launches a prefill "
        f"{wave['launches']} ({causal + full} expected: {full} not causal, "
        f"{causal} causal; by mask {route.masks[False]} not causal, "
        f"{route.masks[True]} causal), in decode {wave['decode_launches']}; "
        f"plain version called {route.plain_calls} times")
    if (wave["launches"] != causal + full or wave["decode_launches"]
            or route.masks != {True: causal, False: full}
            or route.plain_calls):
        raise AssertionError(f"{name}: {wave}, masks {route.masks}, "
                             f"{route.plain_calls} plain calls")
    row.update(waves=[wave], tokens=wave["tokens"], launches=wave["launches"],
               launches_not_causal=route.masks[False],
               plain_calls=route.plain_calls)
    before = K.flash_attention.launches
    row["layer0"], row["logits"], qkv = _plain_route_check(
        lambda: model.prefill(params, batch, max_seq)[0], first, attn_tol,
        SERVE_LOGIT_TOL)
    _log_checks(name, row["layer0"], row["logits"])
    row["attention"] = _serve_kernel_at(*qkv[:3], hw, flush, qkv[3])
    row["profile"] = _profile(
        name, lambda: model.prefill(params, batch, max_seq),
        lambda cache, tok: model.decode(params, cache, {"tokens": tok}))
    K.flash_attention.launches = before        # comparisons do not count
    del params, frames, batch, qkv
    torch.cuda.empty_cache()
    return row


def phase_serve_zoo(hw, device) -> Dict:
    """Phase 10's second half: the rest of the model zoo at full width and
    depth (``SERVE_RECURRENT`` through the engine, ``SERVE_ENCDEC`` through
    its prefill/decode loop).  Raises when a token is out of range, a
    prefill's attention launches are not its arch's, a decode step
    launches the kernel, the plain version runs on the main path, or a
    check of ``_plain_route_check`` fails."""
    import torch

    from repro_torch.core.evaluate import L2_FLUSH_BYTES

    t_phase = time.perf_counter()
    attn_tol = next(p.tol for p in PORTS if p.name == "attention")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = [_serve_engine_arch(name, hw, device, flush, attn_tol)
            for name in SERVE_RECURRENT]
    rows.append(_serve_encdec(hw, device, flush, attn_tol))
    for r in rows:
        at = r.get("attention")
        if at is not None:
            log(f"[serve] {r['arch']} attention at {at['shape']} "
                f"({'causal' if at['causal'] else 'not causal'}): kernel "
                f"{at['ms']:.4f} ms, plain {at['plain_ms']:.4f} ms, library "
                f"{at['library_ms']:.4f} ms ({at['library_backend']}), bound "
                f"{at['bound_ms']:.4f} ms ({at['bound_unit']})")
    del flush
    torch.cuda.empty_cache()
    out = {"archs": rows, "launches_total": sum(r["launches"] for r in rows),
           "phase_s": time.perf_counter() - t_phase}
    log(f"[time] serve zoo {out['phase_s']:.1f} s")
    return out


def _train_losses(lines) -> Dict[int, float]:
    """``{step: loss}`` of the ``[train] step`` lines."""
    out = {}
    for line in lines:
        if line.startswith("[train] step "):
            parts = line.split()
            out[int(parts[2])] = float(parts[4])
    return out


def _children(pid: int):
    """The pids whose parent is ``pid``."""
    import os

    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(name))
    return out


def _train_runs(workdir: Path) -> Dict:
    """Phase 12 (a): the supervisor CLI twice at once, the same command
    but for its checkpoint directory; one run's trainer (not its
    supervisor) SIGKILLed once step ``TRAIN_KILL_AT`` is published.
    Returns both runs' lines, losses and seconds."""
    import os
    import signal

    env = _env()
    runs = {}
    for name in ("killed", "whole"):
        ckpt = workdir / name
        cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
               "--backoff", "1", "--", "--arch", TRAIN_ARCH,
               "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
               "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_CKPT_EVERY),
               "--ckpt-dir", str(ckpt)]
        log_path = workdir / f"{name}.log"
        runs[name] = {"cmd": cmd, "log": log_path,
                      "file": open(log_path, "w"), "t0": time.perf_counter()}
        runs[name]["proc"] = subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=runs[name]["file"],
            stderr=subprocess.STDOUT, start_new_session=True)
    killed = runs["killed"]
    published = workdir / "killed" / f"step_{TRAIN_KILL_AT:010d}"
    deadline = time.perf_counter() + 600
    try:
        while not published.exists():
            if killed["proc"].poll() is not None \
                    or time.perf_counter() > deadline:
                raise AssertionError(
                    f"train: {published.name} was never published:\n"
                    + killed["log"].read_text()[-4000:])
            time.sleep(0.02)
        trainers = _children(killed["proc"].pid)
        if len(trainers) != 1:
            raise AssertionError(f"train: the supervisor has children "
                                 f"{trainers}, not one trainer")
        os.kill(trainers[0], signal.SIGKILL)
        killed["killed_after_s"] = time.perf_counter() - killed["t0"]
        while any("rc" not in run for run in runs.values()):
            if time.perf_counter() > deadline:
                raise AssertionError("train: the runs did not end within "
                                     "600 s")
            for run in runs.values():
                if "rc" not in run and run["proc"].poll() is not None:
                    run["rc"] = run["proc"].returncode
                    run["s"] = time.perf_counter() - run["t0"]
            time.sleep(0.05)
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                os.killpg(run["proc"].pid, signal.SIGKILL)
                run["proc"].wait(timeout=60)
            run["file"].close()
    out = {}
    for name, run in runs.items():
        lines = run["log"].read_text().splitlines()
        for line in lines:
            if line.startswith(("[train]", "[supervisor]", "[watchdog]")):
                log(f"[train] {name}: {line}")
        if run["rc"] != 0:
            raise AssertionError(f"train: the {name} run exited "
                                 f"{run['rc']}:\n" + "\n".join(lines[-60:]))
        out[name] = {"lines": lines, "s": run["s"], "rc": run["rc"]}
    out["killed"]["killed_after_s"] = killed["killed_after_s"]
    return out


def _check_train_runs(runs: Dict) -> Dict:
    """The killed run restarted once and resumed at ``TRAIN_KILL_AT``; its
    losses after the restart match the whole run's within
    ``TRAIN_LOSS_TOL``; the whole run's loss fell."""
    kl, wl = runs["killed"]["lines"], runs["whole"]["lines"]
    restored = f"[train] restored checkpoint at step {TRAIN_KILL_AT}"
    if restored not in kl or not any(x.startswith("[supervisor] attempt 1")
                                     for x in kl) \
            or not any(x.startswith("[supervisor] exited rc=-9")
                       for x in kl):
        raise AssertionError("train: the killed run did not restart from "
                             f"step {TRAIN_KILL_AT}:\n" + "\n".join(kl[-60:]))
    if any(x.startswith("[supervisor] attempt 1") for x in wl) or \
            any("restored checkpoint" in x for x in wl):
        raise AssertionError("train: the whole run restarted")
    whole = _train_losses(wl)
    resumed = _train_losses(kl[kl.index(restored):])
    diffs = {}
    for step in TRAIN_LOSS_STEPS:
        if step not in whole or step not in resumed:
            raise AssertionError(f"train: step {step}'s loss missing "
                                 f"(whole {whole}, resumed {resumed})")
        diffs[step] = abs(resumed[step] - whole[step])
        if diffs[step] > TRAIN_LOSS_TOL:
            raise AssertionError(
                f"train: step {step}'s loss {resumed[step]} after the "
                f"restart, {whole[step]} uninterrupted (tolerance "
                f"{TRAIN_LOSS_TOL})")
    first, last = min(whole), max(whole)
    if not whole[last] < whole[first]:
        raise AssertionError(f"train: the loss did not fall: {whole}")
    return {"losses": whole, "resumed_losses": resumed,
            "resume_diff": diffs, "tolerance": TRAIN_LOSS_TOL,
            "whole_s": runs["whole"]["s"], "killed_s": runs["killed"]["s"],
            "killed_after_s": runs["killed"]["killed_after_s"]}


def _attention_grads(q, k, v, g, causal: bool):
    """Output and q/k/v gradients through ``KernelAttention`` and through
    autograd over the plain model attention, from the same fp32 leaves
    (B, H, S, D) and output gradient."""
    import torch

    from repro_torch.models import attention as A

    def leaves():
        return [t.detach().clone().requires_grad_() for t in (q, k, v)]

    qk, kk, vk = leaves()
    out_k = A.KernelAttention.apply(qk, kk, vk, causal, A.KV_CHUNK)
    grads_k = torch.autograd.grad(out_k, (qk, kk, vk), g)
    qp, kp, vp = leaves()
    plain = A.plain_causal_attention if causal else A.chunked_attention
    out_p = plain(*(t.transpose(1, 2) for t in (qp, kp, vp))).transpose(1, 2)
    grads_p = torch.autograd.grad(out_p, (qp, kp, vp), g)
    errs = {}
    for name, a, b in (("out", out_k, out_p), *zip(("dq", "dk", "dv"),
                                                    grads_k, grads_p)):
        a, b = a.detach(), b.detach()
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30))
    return errs


def _attention_train_checks(device, hw, flush) -> Dict:
    """Phase 12 (c): ``KernelAttention`` against autograd through the
    plain attention at the training shape (causal) and at every compiled
    head dim (causal and not); the guard on a gradient-carrying input; the
    kernel's forward timed against its bound and SDPA, and the backward
    (the plain recompute and its gradient) timed."""
    import types

    import torch

    from repro_torch.kernels.attention import kernel as K
    from repro_torch.configs import ARCHS
    from repro_torch.models import attention as A

    cfg = ARCHS[TRAIN_ARCH]
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(shape):
        return torch.randn(shape, generator=gen, device=device) * 0.5

    checks = []
    shape = (TRAIN_BATCH, cfg.n_heads, TRAIN_SEQ, cfg.eff_head_dim)
    cases = [(shape, True)] + [(TRAIN_ATTN_SMALL + (d,), c)
                               for d in K.HEAD_DIMS for c in (True, False)]
    for shp, causal in cases:
        q, k, v, g = (mk(shp) for _ in range(4))
        errs = _attention_grads(q, k, v, g, causal)
        checks.append({"shape": list(shp), "causal": causal, **errs})
        if max(errs.values()) > TRAIN_GRAD_TOL or \
                any(x != x for x in errs.values()):
            raise AssertionError(f"train: KernelAttention at {shp}, causal "
                                 f"{causal}: {errs} (tolerance "
                                 f"{TRAIN_GRAD_TOL})")
    log(f"[train] KernelAttention vs plain autograd, largest error "
        f"{max(max(c[x] for x in ('out', 'dq', 'dk', 'dv')) for c in checks):.3e}"
        f" over {len(checks)} cases (tolerance {TRAIN_GRAD_TOL})")
    q, k, v, g = (mk(shape) for _ in range(4))
    try:
        K.flash_attention(q.requires_grad_(), k, v)
    except RuntimeError as exc:
        if "KernelAttention" not in str(exc):
            raise
    else:
        raise AssertionError("train: the kernel took a gradient-carrying "
                             "input outside KernelAttention")
    q = q.detach()
    at = _serve_kernel_at(q, k, v, hw, flush, causal=True)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v), causal=True,
                                chunk=A.KV_CHUNK)
    at["backward_ms"] = time_ms(lambda: A.KernelAttention.backward(ctx, g),
                                5, flush)
    log(f"[train] kernel at {at['shape']}: {at['ms']:.4f} ms (bound "
        f"{at['bound_ms']:.4f}, plain {at['plain_ms']:.4f}, SDPA fp32 "
        f"{at['library_ms']:.4f} {at['library_backend']}); backward (plain "
        f"recompute) {at['backward_ms']:.4f} ms")
    return {"checks": checks, "at_train": at}


def _train_step_profile(device, backward_ms: float) -> Dict:
    """Phase 12 (b): one train step of ``TRAIN_ARCH`` at the training
    shape in this process: step seconds, tokens/s, peak memory, the card's
    busy share, the kernel's launches a step and its plain version's
    calls, and the plain backward's share of the step (24 of its timed
    calls over the step)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              make_train_step)

    cfg = ARCHS[TRAIN_ARCH]
    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(3e-4, max(TRAIN_STEPS // 10, 1),
                                 TRAIN_STEPS))
    state = init_train_state(model, opt,
                             torch.Generator(device=device).manual_seed(0),
                             device)
    step = make_train_step(model, opt, StepConfig(loss_chunks=1))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [to_device(make_batch(dcfg, i), device)
               for i in range(TRAIN_TIMED_STEPS + 2)]
    out = {"arch": TRAIN_ARCH, "params": sum(
        p.numel() for p in state.params.parameters()),
        "shape": [TRAIN_BATCH, TRAIN_SEQ], "remat": "nothing_saveable"}
    with _AttentionRoute() as route:
        state, m = step(state, batches[0])                 # warm-up
        torch.cuda.synchronize()
        before = K.flash_attention.launches
        state, m = step(state, batches[1])
        torch.cuda.synchronize()
        out["launches_a_step"] = K.flash_attention.launches - before
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[2:]:
            state, m = step(state, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out["step_s"] = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        prof = _busy_share(lambda: step(state, batches[1]))
        out["plain_calls"] = route.plain_calls
    out["loss"] = loss
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / out["step_s"]
    out["busy_share"] = prof["busy_share"]
    out["profile"] = prof
    out["plain_backward_share"] = cfg.n_layers * backward_ms / 1e3 \
        / out["step_s"]
    if not loss == loss or out["launches_a_step"] == 0 \
            or out["plain_calls"]:
        raise AssertionError(f"train: step loss {loss}, kernel launches "
                             f"{out['launches_a_step']}, plain calls "
                             f"{out['plain_calls']}")
    busy = prof["busy_share"]
    log(f"[train] {TRAIN_ARCH} step at {TRAIN_BATCH}x{TRAIN_SEQ}: "
        f"{out['step_s']:.4f} s, {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{out['peak_memory_gb']:.2f} GB, card busy "
        f"{busy if isinstance(busy, str) else f'{100 * busy:.1f} %'}, "
        f"attention launches a step {out['launches_a_step']} (predicted "
        f"{2 * cfg.n_layers}), plain calls {out['plain_calls']}, plain "
        f"backward {100 * out['plain_backward_share']:.1f} % of the step")
    del state
    torch.cuda.empty_cache()
    return out


def _train_smoke_archs(device) -> Dict:
    """Phase 12 (d): one train step of every SMOKE arch on the card; the
    loss finite, every parameter's gradient there and finite."""
    import torch

    from repro_torch.configs import SMOKES
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, constant_lr
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              loss_and_grads,
                                              make_train_step)

    out = {}
    for name, cfg in SMOKES.items():
        model = build_model(cfg)
        opt = AdamW(lr=constant_lr(1e-3))
        state = init_train_state(
            model, opt, torch.Generator(device=device).manual_seed(0),
            device)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_SEQ,
                          global_batch=TRAIN_SMOKE_BATCH,
                          frontend=cfg.frontend,
                          frontend_len=cfg.frontend_len,
                          frontend_dim=cfg.frontend_dim)
        batch = to_device(make_batch(dcfg, 0), device)
        loss, grads = loss_and_grads(model, state.params, batch,
                                     StepConfig())
        bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
        n_params = sum(1 for _ in state.params.parameters())
        before = K.flash_attention.launches
        state, m = make_train_step(model, opt)(state, batch)
        launches = K.flash_attention.launches - before
        ok = (len(grads) == n_params and not bad
              and bool(torch.isfinite(m["loss"])))
        out[name] = {"loss": float(m["loss"]), "grad_norm":
                     float(m["grad_norm"]), "leaves": len(grads),
                     "launches": launches}
        log(f"[train] {name}: loss {float(m['loss']):.4f}, grad norm "
            f"{float(m['grad_norm']):.4f}, {len(grads)} of {n_params} "
            f"parameters with a finite gradient, {launches} attention "
            f"launches")
        if not ok:
            raise AssertionError(f"train: {name}: loss {float(loss)}, "
                                 f"non-finite gradients {bad[:5]}")
    return out


def phase_train(hw, device) -> Dict:
    """Phase 12: training on the card (the supervisor CLI with a SIGKILL
    and a resume, a step profiled in this process, KernelAttention's
    gradients, every SMOKE arch's step)."""
    import shutil

    import torch

    from repro_torch.core.evaluate import L2_FLUSH_BYTES
    from repro_torch.kernels.attention import kernel as K

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    workdir = ARTIFACT_DIR / "train"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        runs = _check_train_runs(_train_runs(workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[train] {TRAIN_ARCH}: losses {runs['losses']}; resumed "
        f"{runs['resumed_losses']}, differences {runs['resume_diff']} "
        f"(tolerance {TRAIN_LOSS_TOL}); whole run {runs['whole_s']:.1f} s, "
        f"killed run {runs['killed_s']:.1f} s (killed after "
        f"{runs['killed_after_s']:.1f} s)")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    attention = _attention_train_checks(device, hw, flush)
    del flush
    K.flash_attention.launches = 0
    with quiet("phase 12 (b), the step's seconds and busy share"):
        step = _train_step_profile(device,
                                   attention["at_train"]["backward_ms"])
    smoke = _train_smoke_archs(device)
    launches = K.flash_attention.launches
    if launches == 0:
        raise AssertionError("train: the kernel never launched")
    out = {"runs": runs, "step": step, "attention": attention,
           "smoke": smoke, "launches_total": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[time] train {out['phase_s']:.1f} s")
    return out


def _sharded_step(device) -> Dict:
    """Phase 13 (a): TRAIN_ARCH's step through the sharded path on a
    one-rank NCCL mesh, and the plain step, each from the same state on
    the same batches: seconds, tokens/s, peak memory, busy share and the
    kernel's launches a step of both; the losses' and gradient norms'
    relative differences; the sharded path's extra host seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import (DataConfig, make_batch,
                                           shard_batch, to_device)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  default_rules)
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              make_train_step,
                                              shard_train_state)

    cfg = ARCHS[TRAIN_ARCH]
    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(3e-4, max(TRAIN_STEPS // 10, 1),
                                 TRAIN_STEPS))
    scfg = StepConfig(loss_chunks=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    hosts = [make_batch(dcfg, i) for i in range(SHARDED_TIMED_STEPS + 1)]
    mesh = make_host_mesh(1, 1, "cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"sharded: the mesh runs over "
                                 f"{dist.get_backend()}, not NCCL")
        rules = default_rules(multi_pod=False)
        paths = {}
        for name in ("sharded", "plain"):
            state = init_train_state(
                model, opt, torch.Generator(device=device).manual_seed(0),
                device)
            if name == "sharded":
                state = shard_train_state(state, model, mesh, rules)
                step = make_train_step(model, opt, scfg, mesh=mesh,
                                       rules=rules)
                batches = [shard_batch(h, batch_shardings(mesh, rules, h))
                           for h in hosts]
            else:
                step = make_train_step(model, opt, scfg)
                batches = [to_device(h, device) for h in hosts]
            out = {"losses": [], "grad_norms": []}
            with _AttentionRoute() as route:
                state, m = step(state, batches[0])           # warm-up
                out["losses"].append(float(m["loss"]))
                out["grad_norms"].append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.flash_attention.launches = 0
                t0 = time.perf_counter()
                for b in batches[1:]:
                    state, m = step(state, b)
                    out["losses"].append(float(m["loss"]))
                    out["grad_norms"].append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                out["step_s"] = (time.perf_counter() - t0) \
                    / SHARDED_TIMED_STEPS
                out["launches_a_step"] = K.flash_attention.launches \
                    / SHARDED_TIMED_STEPS
                out["launches"] = K.flash_attention.launches
                out["peak_memory_gb"] = torch.cuda.max_memory_allocated() \
                    / 1e9
                prof = _busy_share(lambda: step(state, batches[1]))
                out["plain_calls"] = route.plain_calls
            out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / out["step_s"]
            out["busy_share"] = prof["busy_share"]
            out["profile"] = prof
            paths[name] = out
            del state, batches, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    sh, pl = paths["sharded"], paths["plain"]
    diff = {k: max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(sh[k], pl[k]))
            for k in ("losses", "grad_norms")}
    out = {"arch": TRAIN_ARCH, "shape": [TRAIN_BATCH, TRAIN_SEQ],
           "mesh": [1, 1], "backend": "nccl", "sharded": sh, "plain": pl,
           "rel_diff": diff, "tolerance": SHARDED_TOL,
           "host_overhead_s": sh["step_s"] - pl["step_s"],
           "launches_total": sh["launches"]}
    for name, r in paths.items():
        busy = r["busy_share"]
        log(f"[sharded] {name:7s} {TRAIN_ARCH} at {TRAIN_BATCH}x{TRAIN_SEQ}: "
            f"{r['step_s']:.4f} s a step, {r['tokens_per_s']:.0f} tokens/s, "
            f"peak {r['peak_memory_gb']:.2f} GB, card busy "
            f"{busy if isinstance(busy, str) else f'{100 * busy:.1f} %'}, "
            f"attention launches a step {r['launches_a_step']:g}, plain "
            f"calls {r['plain_calls']}; losses {r['losses']}")
    log(f"[sharded] relative difference to the plain step: loss "
        f"{diff['losses']:.3e}, grad norm {diff['grad_norms']:.3e} "
        f"(tolerance {SHARDED_TOL}); the sharded path's host overhead "
        f"{out['host_overhead_s']:.4f} s a step")
    bad = [n for n, r in paths.items()
           if r["launches_a_step"] != 2 * cfg.n_layers or r["plain_calls"]
           or any(x != x for x in r["losses"])]
    if bad or max(diff.values()) > SHARDED_TOL:
        raise AssertionError(f"sharded: paths {bad} launched the kernel "
                             f"otherwise than {2 * cfg.n_layers} times a "
                             f"step or called its plain version; relative "
                             f"differences {diff}")
    return out


def _system_fleet(hw, workdir: Path) -> Dict:
    """Phase 13 (b): ``python -m repro_torch.launch.fleet --system`` on a
    subprocess lane on cuda:0: each kernel job measured on the card, the
    sharding and serve jobs priced, one store; each job's trials, best and
    seconds, and the lane's launches of each kernel."""
    from repro_torch.core import hwspec
    from repro_torch.kernels.registry import BENCHMARKS

    env = _env()
    out_path, store = workdir / "system.json", workdir / "store.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.fleet", "--system",
           SYSTEM_ARCH, "--hw", hwspec.hardware_key(hw), "--budget",
           str(SYSTEM_BUDGET), "--devices", FLEET_DEVICE, "--store",
           str(store), "--out", str(out_path)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"sharded: the --system fleet exited "
                             f"{res.returncode}:\n{res.stderr[-4000:]}")
    rep = json.loads(out_path.read_text())
    jobs = {j["job"]: j for j in rep["jobs"]}
    kinds = sorted(j.partition(":")[0] for j in jobs)
    launches = rep["lanes"][0]["launches"]
    for name, j in sorted(jobs.items()):
        log(f"[sharded] fleet {name:42s} {j['trials']:2d} trials, best "
            f"{j['best_runtime_s'] * 1e3:10.4f} ms, {j['busy_s']:.3f} s of "
            f"measurement, done at {j['elapsed_s']:.3f} s on the pool clock")
    log(f"[sharded] fleet --system {SYSTEM_ARCH}: {len(jobs)} jobs, lane "
        f"{rep['lanes'][0]['device_name']} launches {launches}; wall "
        f"{wall:.1f} s")
    unlaunched = [k for k in BENCHMARKS if not launches.get(k)]
    bad = [n for n, j in jobs.items() if j["trials"] != SYSTEM_BUDGET
           or not j["best_runtime_s"] < float("inf")]
    if kinds != sorted(["kernel"] * len(BENCHMARKS) + ["serve", "sharding"]) \
            or unlaunched or bad:
        raise AssertionError(f"sharded: fleet jobs {kinds}, kernels the "
                             f"lane never launched {unlaunched}, jobs short "
                             f"of their budget or infinite {bad}")
    from repro_torch.tuning import ConfigStore

    return {"cmd": cmd[1:], "jobs": rep["jobs"], "lane_launches": launches,
            "wall_s": wall, "store_entries": len(ConfigStore(str(store)))}


def phase_sharded(hw, device) -> Dict:
    """Phase 13: the sharded train step on a one-rank NCCL mesh beside the
    plain step, and the fleet's whole-system mode on the card."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with quiet("phase 13 (a), the sharded step's host overhead"):
        step = _sharded_step(device)
    workdir = ARTIFACT_DIR / "system"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        fleet = _system_fleet(hw, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"step": step, "fleet": fleet,
           "launches_total": step["launches_total"],
           "phase_s": time.perf_counter() - t_phase}
    log(f"[time] sharded {out['phase_s']:.1f} s")
    return out


def _dry_vs_card(hw, device) -> Dict:
    """Phase 14 (a): the dry run's count of TRAIN_ARCH's step at the
    training shape on a one-rank fake mesh (flops by unit, bytes, kernel
    launches, peak live bytes, the roofline at ``hw``'s rates) beside the
    same step on the card, timed by ``MeasuredStepEvaluator`` (the median
    of its timed steps, the step's own peak), the kernel's launches a step
    and, over one more step, the card's time in kernels under
    ``torch.profiler``.  It fails unless the launches agree, the plain
    version is never called, every timed loss is finite and the measured
    peak lies within DRY_PEAK_BAND of the predicted one."""
    import math

    from repro_torch.core.step_tuner import STEPS_TIMED, MeasuredStepEvaluator
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    from repro_torch.train.train_step import StepConfig

    scfg = StepConfig(loss_chunks=1)
    t0 = time.perf_counter()
    count = dryrun.count_train_step(TRAIN_ARCH, scfg, TRAIN_BATCH, TRAIN_SEQ,
                                    sharded=True)
    count_s = time.perf_counter() - t0
    rf = analysis.analyze_count(count, chips=1, hw=hw)
    ev = MeasuredStepEvaluator(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, device,
                               verbose=False)
    cfg = {"MICROBATCHES": scfg.microbatches, "REMAT": scfg.remat,
           "LOSS_CHUNKS": scfg.loss_chunks, "KV_CHUNK": scfg.kv_chunk,
           "FSDP": 0}
    seen = {"before": 0}

    def after(step, state, batch):
        seen["timed"] = K.flash_attention.launches - seen["before"]
        seen["prof"] = _busy_share(lambda: step(state, batch))

    ev.after = after
    with _AttentionRoute() as route:
        seen["before"] = K.flash_attention.launches
        ev._evaluate(ev.space.index_of(cfg), False)
        launches_total = K.flash_attention.launches - seen["before"]
        plain_calls = route.plain_calls
    test = ev.tests[-1]
    step_s, peak, prof = test["seconds"], test["peak_bytes"], seen["prof"]
    launches = seen["timed"] / (STEPS_TIMED + 1)       # with the warm-up
    out = {"arch": TRAIN_ARCH, "shape": [TRAIN_BATCH, TRAIN_SEQ],
           "mesh": [1, 1], "remat": scfg.remat, "loss_chunks": 1,
           "count_s": count_s, "flops": count.flops,
           "bytes": count.bytes, "ops": count.ops,
           "transcendentals": count.transcendentals,
           "launches_predicted": count.launches.get("attention", 0),
           "peak_predicted_bytes": count.peak_bytes,
           "compute_s": rf.compute_s, "memory_s": rf.memory_s,
           "collective_s": rf.collective_s, "bound_s": rf.bound_time,
           "dominant": rf.dominant,
           "step_s": step_s, "test_s": ev.seconds,
           "peak_measured_bytes": peak, "launches_a_step": launches,
           "plain_calls": plain_calls, "device_s": prof["device_s"],
           "busy_share": prof["busy_share"], "losses": test["losses"],
           "peak_ratio": peak / count.peak_bytes,
           "peak_band": list(DRY_PEAK_BAND),
           "step_to_bound": step_s / rf.bound_time,
           "launches_total": launches_total}
    log(f"[dryrun] {TRAIN_ARCH} step at {TRAIN_BATCH}x{TRAIN_SEQ} counted in "
        f"{count_s:.1f} s: flops bf16 {count.flops['bf16']:.4e}, fp32 "
        f"{count.flops['fp32']:.4e}, 3xTF32 {count.flops['tf32x3']:.4e}; "
        f"bytes {count.bytes:.4e}; {count.ops} ops; attention launches "
        f"{out['launches_predicted']}; peak {count.peak_bytes / 1e9:.2f} GB; "
        f"compute {rf.compute_s * 1e3:.2f} ms, memory "
        f"{rf.memory_s * 1e3:.2f} ms, collective "
        f"{rf.collective_s * 1e3:.2f} ms -> bound {rf.bound_time * 1e3:.2f} "
        f"ms ({rf.dominant})")
    device_s = prof["device_s"]
    log(f"[dryrun] on the card: step {step_s:.4f} s (median of "
        f"{STEPS_TIMED}), peak {peak / 1e9:.2f} GB, attention launches "
        f"a step {launches:g}, plain calls {plain_calls}, device time "
        f"{device_s if isinstance(device_s, str) else f'{device_s:.4f} s'}; "
        f"measured/predicted peak {out['peak_ratio']:.3f} (band "
        f"{DRY_PEAK_BAND}), step/bound {out['step_to_bound']:.3f}; losses "
        f"{test['losses']}")
    lo, hi = DRY_PEAK_BAND
    if launches != out["launches_predicted"] or plain_calls \
            or not all(math.isfinite(x) for x in test["losses"]) \
            or not lo <= out["peak_ratio"] <= hi:
        raise AssertionError(
            f"dryrun: the card launched the kernel {launches} times a step, "
            f"the dry run counted {out['launches_predicted']}; plain calls "
            f"{plain_calls}; losses {test['losses']}; measured/predicted "
            f"peak {out['peak_ratio']:.4f} outside {DRY_PEAK_BAND}")
    return out


def _env() -> Dict[str, str]:
    """The environment with the checkout's ``src`` first on PYTHONPATH."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


# the card-free work's processes (``start_card_free``), each the leader of
# its own session, which ``quiet`` pauses; and the seconds it paused them
# for each figure
CARD_FREE_PROCS: list = []
CARD_FREE_PAUSED: Dict[str, float] = {}


def start_card_free() -> Dict:
    """The work that needs no card, started at the script's start so that
    it runs beside the card's phases, each process at the lowest CPU
    priority and paused while a host-bound figure is taken (``quiet``):
    phase 14 (b)'s dry-run cells (``_start_cells``) and phase 15's step
    tune.  ``stop_card_free`` stops what is left of it."""
    import shutil

    for sub in ("dryrun", "examples"):
        shutil.rmtree(ARTIFACT_DIR / sub, ignore_errors=True)
        (ARTIFACT_DIR / sub).mkdir(parents=True)
    work = {"cells": _start_cells(ARTIFACT_DIR / "dryrun"),
            "step_tune": _start_example(
                "torch_autotune_train_step", EXAMPLE_STEP_TUNE + (
                    "--out", str(ARTIFACT_DIR / "examples" /
                                 "step_tune.json")),
                ARTIFACT_DIR / "examples", _env())}
    _lowest_priority(work["step_tune"]["proc"].pid)
    CARD_FREE_PROCS[:] = [proc for _, proc in work["cells"]] \
        + [work["step_tune"]["proc"]]
    return work


@contextlib.contextmanager
def quiet(figure: str):
    """The card-free work paused (SIGSTOP to each live process's session,
    SIGCONT after) while ``figure``, host-bound, is taken: the host's CPUs
    are shared, and work beside a decode loop or a step slows it.  The
    seconds paused go to CARD_FREE_PAUSED."""
    import os
    import signal

    stopped = []
    for proc in CARD_FREE_PROCS:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGSTOP)
                stopped.append(proc)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for proc in stopped:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGCONT)
        CARD_FREE_PAUSED[figure] = time.perf_counter() - t0
        log(f"[device] the card-free work ({len(stopped)} processes) "
            f"paused {CARD_FREE_PAUSED[figure]:.1f} s for {figure}")


def stop_card_free(work: Dict) -> None:
    """Kill what is still running of ``start_card_free``'s work."""
    import os
    import signal

    for _, proc in work["cells"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    run = work["step_tune"]
    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait(timeout=60)
    run["file"].close()


def _lowest_priority(pid: int) -> None:
    import os

    os.setpriority(os.PRIO_PROCESS, pid, 19)


def _start_cells(workdir: Path):
    """Phase 14 (b), started: one ``python -m repro_torch.launch.dryrun``
    process a (arch, shape, --mesh) of DRY_CELLS, all at once."""
    env = _env()
    procs = []
    for arch, shape, mesh in DRY_CELLS:
        out = workdir / f"{arch}-{shape}-{mesh}.jsonl"
        # its output to a file: a pipe left unread for minutes could fill
        with open(out.with_suffix(".log"), "w") as log_file:
            procs.append((out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
                 str(out), "--sites"],
                stdout=log_file, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT, start_new_session=True)))
        _lowest_priority(procs[-1][1].pid)
    return procs


def _finish_cells(procs) -> list:
    """Phase 14 (b), awaited: every record ``ok`` (or skipped with the JAX
    package's reason), each printed with its per-device peak against 80 GB,
    its terms and its seconds, and with the collective seconds and the
    peak's bytes of each of DRY_SITES (forward and backward) beside the
    record's whole."""
    records = []
    for out, proc in procs:
        proc.wait(timeout=900)
        lines = out.read_text().splitlines() if out.exists() else []
        if proc.returncode != 0 or not lines:
            text = out.with_suffix(".log").read_text()
            raise AssertionError(f"dryrun CLI for {out.name} exited "
                                 f"{proc.returncode}: {text[-3000:]}")
        for line in lines:
            rec = json.loads(line)
            records.append(rec)
            if rec["status"] == "skipped":
                log(f"[dryrun] {rec['arch']} x {rec['shape']} x "
                    f"{rec['mesh']}: skipped ({rec['reason']})")
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun: {rec}")
            rf, mem = rec["roofline"], rec["memory"]
            log(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
                f"({rec['chips']} ranks): peak "
                f"{mem['peak_bytes'] / 2**30:.2f} GiB a device against the "
                f"card's 80 GB ({80e9 / 2**30:.2f} GiB); compute "
                f"{rf['compute_s'] * 1e3:.2f} ms, memory "
                f"{rf['memory_s'] * 1e3:.2f} ms, collective "
                f"{rf['collective_s'] * 1e3:.2f} ms ({rf['dominant']}); "
                f"set-up {rec['lower_s']} s, counted step "
                f"{rec['compile_s']} s")
            rec["dry_sites"] = _site_shares(rec)
            for site, at in rec["dry_sites"].items():
                log(f"[dryrun]   {site}: collectives "
                    f"{at['collective_s'] * 1e3:.2f} ms of "
                    f"{rf['collective_s'] * 1e3:.2f} ms "
                    f"({at['collective_share']:.4f}); at the peak "
                    f"{at['peak_bytes'] / 1e9:.3f} GB of "
                    f"{mem['peak_bytes'] / 1e9:.3f} GB "
                    f"({at['peak_share']:.4f})")
    return records


def _site_shares(rec) -> Dict:
    """Each of DRY_SITES' collective seconds and peak bytes in a record's
    ``sites`` (its forward and its backward added) and their shares of
    the record's collective term and peak."""
    sites = rec["sites"]
    out = {}
    for site in DRY_SITES:
        names = (site, site + " (backward)")
        coll = sum(sites["collective_s"].get(n, 0.0) for n in names)
        peak = sum(sites["peak_bytes"].get(n, 0.0) for n in names)
        total_s = rec["roofline"]["collective_s"]
        out[site] = {"collective_s": coll,
                     "collective_share": coll / total_s if total_s else 0.0,
                     "peak_bytes": peak,
                     "peak_share": peak / rec["memory"]["peak_bytes"]}
    return out


def _sharding_compiled(indices) -> list:
    """Phase 14 (d), in a process of its own:
    ``ShardingProblem(SHARDING_ARCH, backend="compiled")`` at ``indices``
    of its space on the H100 SXM's spec; each test's runtime, its dominant
    term's counters and its seconds."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core.hwspec import H100_SXM
    from repro_torch.distributed.tuning import ShardingProblem
    from repro_torch.launch import dryrun

    records = []
    lower = dryrun.lower_cell

    def kept(*args, **kwargs):
        records.append(lower(*args, **kwargs))
        return records[-1]

    dryrun.lower_cell = kept
    problem = ShardingProblem(SHARDING_ARCH, backend="compiled")
    fn = problem.make_evaluator(H100_SXM)
    out = []
    for i in indices:
        t0 = time.perf_counter()
        rt, cs, cost = fn(i, True)
        rf = records[-1]["roofline"]
        out.append({"index": i, "config": dict(problem.space()[i]),
                    "runtime_s": rt, "cost_s": cost,
                    "seconds": time.perf_counter() - t0,
                    "dominant": rf["dominant"],
                    "terms_s": {k: rf[k] for k in ("compute_s", "memory_s",
                                                   "collective_s")},
                    "peak_bytes": records[-1]["memory"]["peak_bytes"]})
    return out


def _measured_tune(workdir: Path, device) -> Dict:
    """Phase 14 (c): ``launch.tune --backend measured`` through its entry
    point, in this process, on the card: the training phase's profiled
    tests saved as a model, the profile searcher's tests; every test's
    configuration and seconds (or OOM); then the best configuration
    re-timed beside the default StepConfig."""
    import math

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.step_tuner import (MeasuredStepEvaluator,
                                             make_step_space)
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.launch import tune

    # the kernel at every (B, H, S, D) the tune gives it, held against
    # autograd through the plain attention (these launches are not the
    # main path's)
    arch = ARCHS[STEP_TUNE_ARCH]
    gen = torch.Generator(device=device).manual_seed(0)
    checks = []
    for m in make_step_space().parameters[0].values:
        shp = (STEP_TUNE_BATCH // m, arch.n_heads, STEP_TUNE_SEQ,
               arch.eff_head_dim)
        q, k, v, g = (torch.randn(shp, generator=gen, device=device) * 0.5
                      for _ in range(4))
        errs = _attention_grads(q, k, v, g, True)
        checks.append({"shape": list(shp), "causal": True, **errs})
        del q, k, v, g
        if max(errs.values()) > TRAIN_GRAD_TOL or \
                any(x != x for x in errs.values()):
            raise AssertionError(f"tune: KernelAttention at {shp}, causal: "
                                 f"{errs} (tolerance {TRAIN_GRAD_TOL})")
    torch.cuda.empty_cache()
    worst = max(max(c[x] for x in ("out", "dq", "dk", "dv")) for c in checks)
    log(f"[tune] KernelAttention vs plain autograd at "
        f"{[c['shape'] for c in checks]}, causal: largest error "
        f"{worst:.3e} (tolerance {TRAIN_GRAD_TOL})")

    out_json = workdir / "tune.json"
    argv = ["--arch", STEP_TUNE_ARCH, "--backend", "measured", "--batch",
            str(STEP_TUNE_BATCH), "--seq", str(STEP_TUNE_SEQ), "--searcher",
            "profile", "--train-samples", str(STEP_TUNE_TRAIN_SAMPLES),
            "--budget", str(STEP_TUNE_BUDGET), "--save-model",
            str(workdir / "step_tppc.json"), "--out", str(out_json)]
    t0 = time.perf_counter()
    with _AttentionRoute() as route:
        before = K.flash_attention.launches
        rc = tune.main(argv)
        launches = K.flash_attention.launches - before
        tune_s = time.perf_counter() - t0
        rec = json.loads(out_json.read_text())
        ev = MeasuredStepEvaluator(STEP_TUNE_ARCH, STEP_TUNE_BATCH,
                                   STEP_TUNE_SEQ, device, verbose=False)
        default = {"MICROBATCHES": 1, "REMAT": "nothing_saveable",
                   "LOSS_CHUNKS": 1, "KV_CHUNK": 1024, "FSDP": 0}
        retimed = {}
        for name, cfg in (("best", rec["best_config"]),
                          ("default", default)):
            rt, _, _ = ev._evaluate(ev.space.index_of(cfg), False)
            retimed[name] = {"config": cfg, "seconds": rt,
                             "peak_bytes": ev.tests[-1]["peak_bytes"]}
        launches_all = K.flash_attention.launches - before
        plain_calls = route.plain_calls
    torch.cuda.empty_cache()
    for t in rec["tests"]:
        what = "OOM" if t["seconds"] is None else f"{t['seconds']:.4f} s"
        log(f"[tune] {t['config']} -> {what}, peak "
            f"{t['peak_bytes'] / 1e9:.2f} GB")
    log(f"[tune] {STEP_TUNE_ARCH} at {STEP_TUNE_BATCH}x{STEP_TUNE_SEQ} on "
        f"the card: {len(rec['tests'])} tests ({rec['ooms']} OOM) in "
        f"{tune_s:.1f} s; "
        f"best {rec['best_ms']:.1f} ms {rec['best_config']}; re-timed: best "
        f"{retimed['best']['seconds']:.4f} s, default "
        f"{retimed['default']['seconds']:.4f} s; attention launches "
        f"{launches_all}, plain calls {plain_calls}")
    bad = [t for t in rec["tests"] + ev.tests
           if not all(math.isfinite(x) for x in t["losses"])]
    if rc != 0 or launches == 0 or plain_calls or bad:
        raise AssertionError(f"tune: exit {rc}, attention launches "
                             f"{launches}, plain calls {plain_calls}; tests "
                             f"with a loss not finite: {bad}")
    return {"arch": STEP_TUNE_ARCH,
            "shape": [STEP_TUNE_BATCH, STEP_TUNE_SEQ],
            "searcher": rec["searcher"], "steps": rec["steps"],
            "best_ms": rec["best_ms"], "best_config": rec["best_config"],
            "tests": rec["tests"], "ooms": rec["ooms"], "tune_s": tune_s,
            "retimed": retimed, "launches_total": launches_all,
            "plain_calls": plain_calls, "kernel_checks": checks,
            "tolerance": TRAIN_GRAD_TOL}


def phase_dryrun(hw, device, procs) -> Dict:
    """Phase 14: the dry run against the card, production cells through
    the dry-run CLI (``procs``, started at the script's start), the
    measured step tune and the compiled sharding backend."""
    import concurrent.futures
    import multiprocessing
    import shutil

    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    workdir = ARTIFACT_DIR / "dryrun"
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        sharding = pool.submit(_sharding_compiled, SHARDING_CONFIGS)
        dry = _dry_vs_card(hw, device)
        tuned = _measured_tune(workdir, device)
        cells = _finish_cells(procs)
        sharding = sharding.result(timeout=900)
    finally:
        for worker in list(getattr(pool, "_processes", {}).values()):
            if worker.is_alive():
                worker.terminate()
        pool.shutdown(wait=True, cancel_futures=True)
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    for r in sharding:
        log(f"[sharding] compiled {SHARDING_ARCH} {r['config']}: "
            f"{r['runtime_s'] * 1e3:.2f} ms ({r['dominant']}-bound), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB a device, "
            f"{r['seconds']:.1f} s")
    out = {"step": dry, "cells": cells, "tune": tuned,
           "sharding_compiled": sharding,
           "launches_total": dry["launches_total"]
           + tuned["launches_total"],
           "phase_s": time.perf_counter() - t_phase}
    log(f"[time] dryrun {out['phase_s']:.1f} s")
    return out


def _start_example(name: str, args, workdir: Path, env):
    """``python examples/<name>.py args`` from the checkout's root, in a
    session of its own, its output to ``workdir/<name>.log``."""
    log_file = open(workdir / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=str(ROOT), env=env, stdout=log_file, stderr=subprocess.STDOUT,
        start_new_session=True)
    return {"name": name, "proc": proc, "file": log_file,
            "t0": time.perf_counter()}


def _finish_example(run, workdir: Path) -> Tuple[str, float]:
    """Wait for a started example; its output and the seconds from its
    start to the end of the wait (its run time where it is awaited as soon
    as it starts).  Raises on a non-zero exit or after EXAMPLE_TIMEOUT seconds
    of waiting (its session killed)."""
    import os
    import signal

    try:
        run["proc"].wait(timeout=EXAMPLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait(timeout=60)
    finally:
        run["file"].close()
    seconds = time.perf_counter() - run["t0"]
    text = (workdir / f"{run['name']}.log").read_text()
    rc = run["proc"].returncode
    log(f"[examples] {run['name']}: exit {rc}, {seconds:.1f} s after its "
        f"start")
    if rc != 0:
        raise AssertionError(f"examples: {run['name']} exited {rc}:\n"
                             + text[-4000:])
    return text, seconds


def _grab(pattern: str, text: str, name: str):
    import re

    m = re.search(pattern, text, re.M)
    if m is None:
        raise AssertionError(f"examples: {name} printed no line matching "
                             f"{pattern!r}:\n{text[-3000:]}")
    return m.groups()


def _example_module(name: str):
    """``examples/<name>.py`` imported from the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_attention(device) -> Dict:
    """The attention kernel at every shape phase 15's examples give it,
    held against its plain version within attention's tolerance (these
    launches are not a main path's): each wave of torch_serve_batch's
    requests at its slots (the wave's requests, the arch's heads, its
    longest prompt, the head dim) and torch_train_lm's step (batch, heads,
    seq, head dim), causal, in fp32 as the model hands them to the kernel,
    from a seed.  Also the serving waves' count, for its launches."""
    import inspect

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.attention import kernel as K

    port = next(p for p in PORTS if p.name == "attention")
    serve = _example_module("torch_serve_batch")
    slots = inspect.signature(serve.run).parameters["batch_size"].default
    requests = serve.make_requests()
    cfg = ARCHS[serve.ARCH]
    waves = [requests[i:i + slots] for i in range(0, len(requests), slots)]
    shapes = [("serve_batch", (len(w), cfg.n_heads,
                               max(len(r.prompt) for r in w),
                               cfg.eff_head_dim)) for w in waves]
    cmd = _example_module("torch_train_lm").command()
    arg = {cmd[i]: cmd[i + 1] for i in range(len(cmd) - 1)}
    tcfg = ARCHS[arg["--arch"]]
    shapes.append(("train_lm", (int(arg["--batch"]), tcfg.n_heads,
                                int(arg["--seq"]), tcfg.eff_head_dim)))
    gen = torch.Generator(device=device).manual_seed(0)
    checks = []
    for example, shape in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   for _ in range(3))
        got = K.flash_attention(q, k, v, causal=True)
        ref = K.flash_attention_plain(q, k, v, causal=True)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        checks.append({"example": example, "shape": list(shape),
                       "causal": True, "max_abs_err": err,
                       "max_rel_err": rel, "tolerance": port.tol})
        log(f"[examples] {example} attention {shape} (causal): kernel vs "
            f"plain max abs {err:.3e}, rel {rel:.3e} (tolerance "
            f"{port.tol})")
        if not rel <= port.tol:
            raise AssertionError(f"examples: attention {checks[-1]}")
    return {"checks": checks, "serve_waves": len(waves),
            "serve_layers": cfg.n_layers}


def phase_examples(device, step_tune) -> Dict:
    """Phase 15: the port's five examples, each as a user runs it (a
    subprocess from the checkout's root, on the card unless the example
    needs none), each to exit 0, their key figures parsed from what they
    print: the quickstart's best configuration, tests and error against
    the fp32 oracle (within QUICKSTART_TOL, the kernel launched); the
    serving autotuner's second run at 0 live trials; the engine's tokens/s
    (the attention kernel launched once a layer a wave); the trainer's
    last loss and its checkpoints; the step tune's (``step_tune``, started
    at the script's start) best beside random's.  The attention kernel is
    held against its plain version at the engine's and the trainer's
    shapes (``_example_attention``)."""
    import ast
    import math
    import re
    import shutil

    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    workdir = ARTIFACT_DIR / "examples"
    env = _env()
    step_json = workdir / "step_tune.json"
    ckpt = workdir / "ckpt"
    out: Dict = {"attention": _example_attention(device)}
    try:
        text, sec = _finish_example(
            _start_example("torch_quickstart", (), workdir, env), workdir)
        tests, where, us = _grab(r"^best after (\d+) empirical tests "
                                 r"\(measured on (.+?), \S+\): ([\d.]+) us",
                                 text, "quickstart")
        err, rel = _grab(r"max err (\S+) \(relative (\S+),", text,
                         "quickstart")
        (launches,) = _grab(r"^GEMM kernel launches: (\d+)", text,
                            "quickstart")
        (cfg,) = _grab(r"^best config: (\{.*\})$", text, "quickstart")
        out["quickstart"] = {
            "tests": int(tests), "card": where, "best_us": float(us),
            "best_config": ast.literal_eval(cfg), "max_err": float(err),
            "rel_err": float(rel), "launches": int(launches), "s": sec}
        if not (float(rel) <= QUICKSTART_TOL and int(launches) > 0
                and where == torch.cuda.get_device_name(device)):
            raise AssertionError(f"examples: quickstart {out['quickstart']}")

        text, sec = _finish_example(
            _start_example("torch_serve_autotune", (), workdir, env),
            workdir)
        (trials,) = _grab(r"^run 2 spent (\d+) live trials total", text,
                          "serve_autotune")
        out["serve_autotune"] = {
            "run1_retunes": text.count("tuned live"),
            "run2_live_trials": int(trials), "s": sec}
        if int(trials) != 0 or not text.count("tuned live"):
            raise AssertionError(f"examples: serve_autotune "
                                 f"{out['serve_autotune']}")

        with quiet("phase 15, the engine's tokens/s"):
            text, sec = _finish_example(
                _start_example("torch_serve_batch", (), workdir, env),
                workdir)
        n_tok, secs, rate, card = _grab(
            r"^(\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s, (.+)\)$", text,
            "serve_batch")
        (launches,) = _grab(r"attention kernel launches (\d+)", text,
                            "serve_batch")
        requests = re.findall(r"^request \d+: (\[.*\])$", text, re.M)
        attn = out["attention"]
        out["serve_batch"] = {
            "tokens": int(n_tok), "seconds": float(secs),
            "tok_per_s": float(rate), "card": card,
            "launches": int(launches),
            "launches_expected": attn["serve_layers"] * attn["serve_waves"],
            "s": sec}
        if not (int(n_tok) == 80 and len(requests) == 10 and all(
                len(ast.literal_eval(r)) == 8 for r in requests)
                and int(launches) == out["serve_batch"]["launches_expected"]
                and card == torch.cuda.get_device_name(device)):
            raise AssertionError(f"examples: serve_batch "
                                 f"{out['serve_batch']}")

        text, sec = _finish_example(
            _start_example("torch_train_lm", EXAMPLE_TRAIN
                           + ("--ckpt-dir", str(ckpt)), workdir, env),
            workdir)
        (loss,) = _grab(r"^\[train\] done: final loss (\S+)$", text,
                        "train_lm")
        steps = sorted(p.name for p in ckpt.glob("step_*"))
        out["train_lm"] = {"final_loss": float(loss), "checkpoints": steps,
                           "s": sec}
        if not math.isfinite(float(loss)) or steps != [
                "step_0000000002", "step_0000000004"]:
            raise AssertionError(f"examples: train_lm {out['train_lm']}")
        shutil.rmtree(ckpt, ignore_errors=True)

        text, sec = _finish_example(step_tune, workdir)
        rec = json.loads(step_json.read_text())
        out["step_tune"] = {
            "space": rec["space"], "train_samples": rec["train_samples"],
            "budget": rec["budget"], "profile": rec["profile"],
            "random": rec["random"], "train_best_ms": rec["train_best_ms"],
            "total_seconds": rec["total_seconds"], "s": sec}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for name, r in out.items():
        log(f"[examples] {name}: " + json.dumps(r))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[time] examples {out['phase_s']:.1f} s")
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
    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    from repro_torch.kernels.attention.kernel import HEAD_DIMS, SPLIT_V_DIMS

    missing = sorted(set(HEAD_DIMS) - set(ATTENTION_CHECK_DIMS))
    if missing:
        print(f"chip_smoke: ATTENTION_CHECK_DIMS misses the compiled head "
              f"dims {missing}", file=sys.stderr)
        return 2
    missing = sorted(set(SPLIT_V_DIMS) - set(ATTENTION_SPLIT_CHECK_DIMS))
    if missing:
        print(f"chip_smoke: ATTENTION_SPLIT_CHECK_DIMS misses the compiled "
              f"(qk, V) head dims {missing}", file=sys.stderr)
        return 2

    # phase 1: device
    device = resolve_device()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    hw = hwspec.detect()
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; spec {hw.name}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the card-free work, beside every phase: phase 14 (b)'s cells and
    # phase 15's step tune
    card_free = start_card_free()
    try:
        return _phases(device, name, count, hw, t_start, card_free)
    finally:
        stop_card_free(card_free)


def _phases(device, name, count, hw, t_start, card_free) -> int:
    """Phases 2-15 and the report (phase 11)."""
    import torch

    from repro_torch.core.evaluate import L2_FLUSH_BYTES
    from repro_torch.kernels.registry import BENCHMARKS

    # phase 2: build, and the tensor cores' rate through mma.sync
    hmma, nbody_sass, spill = phase_build()
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

    # phase 8: the fleet on the card
    fleet = phase_fleet(records, {p.name: r[1]["main_path"]
                                  for p, r in zip(PORTS, results)},
                        hw, device)

    # phase 9: the tuning service on the card
    with quiet("phase 9, the service's seconds"):
        service = phase_service(records, device)

    # phase 10: serving on the card
    with quiet("phase 10, qwen2.5-3b's serving"):
        serve = phase_serve(hw, device)
    serve["service_serve_kind"] = service["serve_kind"]
    serve["zoo"] = phase_serve_zoo(hw, device)

    # phase 12: training on the card (reported with the rest in phase 11)
    train = phase_train(hw, device)

    # phase 13: the sharded step and the fleet's --system on the card
    sharded = phase_sharded(hw, device)

    # phase 15: the examples, each as a user runs it (before phase 14, so
    # that phase 14 (b)'s longest cell has ended when it is awaited)
    examples = phase_examples(device, card_free["step_tune"])

    # phase 14: the dry run and step tuning on the card
    dry = phase_dryrun(hw, device, card_free["cells"])

    # phase 11: report
    t0 = time.perf_counter()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    entries, floors, variants = [], {}, {}
    for port, (head, rest, port_records, _) in zip(PORTS, results):
        bench = BENCHMARKS[port.name]
        times = kernel_times(port, bench, bench.inputs[port.tune],
                             port_records[port.tune], hw, device, flush)
        entry = {**head, **times, **rest}
        if port.name == "attention":
            # the serve phase's prefills launch it on their main path too
            zoo = serve["zoo"]
            entry["launches"] += serve["launches_total"] \
                + zoo["launches_total"]
            entry["launches_serve"] = serve["launches_total"]
            entry["launches_serve_zoo"] = {r["arch"]: r["launches"]
                                           for r in zoo["archs"]}
            entry["at_serve"] = serve["attention_at_serve"]
            entry["at_serve_zoo"] = {r["arch"]: r["attention"]
                                     for r in zoo["archs"]
                                     if r.get("attention")}
            # and phase 12's training steps in this process
            entry["launches"] += train["launches_total"]
            entry["launches_train"] = train["launches_total"]
            entry["launches_train_step"] = train["step"]["launches_a_step"]
            entry["at_train"] = train["attention"]["at_train"]
            # and phase 13's sharded steps, rank 0's local heads
            entry["launches"] += sharded["launches_total"]
            entry["launches_sharded"] = sharded["launches_total"]
            # and phase 14's steps: beside the dry run, the measured tune
            entry["launches"] += dry["launches_total"]
            entry["launches_dryrun_tune"] = dry["launches_total"]
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
            lib = at["library_ms"]
            log(f"[report] {port.name} {at['shape']}: best "
                f"{at['kernel_ms_best']:.4f} ms, default "
                f"{at['kernel_ms_default']:.4f} ms, plain "
                f"{at['plain_ms']:.4f} ms, library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{at['bound_ms']:.4f} ms"
                + _extra_report(at, floor.get(at["shape"])))
    report = {"kernels": entries,
              "not_ported": [{"name": n, "replaces": r}
                             for n, r in NOT_PORTED],
              "transfer": transfer, "exact_hit": exact, "fleet": fleet,
              "service": service, "serve": serve, "train": train,
              "sharded": sharded,
              "dryrun": {k: dry[k] for k in ("step", "cells",
                                             "sharding_compiled",
                                             "phase_s")},
              "tune": dry["tune"], "examples": examples,
              "card_free_paused_s": CARD_FREE_PAUSED,
              "hmma_instructions": hmma, "nbody_sass": nbody_sass,
              "spill_store_bytes": spill,
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
