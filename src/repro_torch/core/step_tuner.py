"""The paper's technique applied to the framework itself: profile-counter-
guided search over the train STEP's configuration (microbatches, remat
policy, loss chunking, attention chunk, FSDP on/off).

The JAX package's ``repro.core.step_tuner`` carried over, with two
backends on one space and one protocol:

* ``CompiledStepEvaluator`` (priced): "kernel" ↦ the train step of a
  production cell, "performance counters" ↦ the dry run's per-rank op
  count (``launch.dryrun.lower_cell``: flops, bytes, collective bytes,
  peak live bytes), "runtime" ↦ its three-term roofline at the H100's
  rates; a configuration whose peak exceeds ``hbm_bytes`` is priced 100×
  (unrunnable).  The counters map onto the Hopper names as the JAX ones
  map onto the TPU's (``core.counters.TPU_NAMES``), constant for constant.
* ``MeasuredStepEvaluator`` (on the card): one empirical test is one
  configuration of the real train step at a batch and sequence that one
  card holds, timed: a warm-up step, then the median of ``STEPS_TIMED``
  steps timed with CUDA events; its counters are the op count of the same
  step (``launch.dryrun.count_train_step``) mapped as above with the
  measured seconds as the runtime and the step's own peak as the live
  bytes: the state and one batch, as the count holds them, plus the most
  ``torch.cuda.max_memory_allocated`` rose above what was held after the
  warm-up step (by then the libraries' one-time workspaces exist, so the
  reading does not depend on what the process ran before).  KV_CHUNK is
  ``KernelAttention``'s recompute chunk; FSDP = 1 runs the sharded step
  on a one-rank NCCL mesh (what FSDP is on one card).
  ``torch.cuda.OutOfMemoryError`` marks a configuration as unrunnable, as
  the priced backend's rule does: its runtime is 100× its count's
  roofline bound, and it is counted (``ooms``) and printed.  No other
  error is caught.  The cost of a test is its real seconds.

Both cache a configuration's result (a repeat is free) behind one lock.
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, Optional, Tuple

from repro_torch.core import counters as C
from repro_torch.core.account import Evaluator
from repro_torch.core.counters import CounterSet
from repro_torch.core.hwspec import H100_SXM
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace

STEPS_TIMED = 3       # timed steps a test, after one warm-up step
OOM_PENALTY = 100.0   # an unrunnable configuration's runtime factor


def make_step_space() -> TuningSpace:
    params = [
        TuningParameter("MICROBATCHES", (1, 2, 4, 8)),
        TuningParameter("REMAT", ("nothing_saveable", "dots_saveable")),
        TuningParameter("LOSS_CHUNKS", (1, 4, 8, 16)),
        TuningParameter("KV_CHUNK", (512, 1024, 2048, 4096)),
        TuningParameter("FSDP", (0, 1)),
    ]
    return TuningSpace(params, name="train_step")


def step_overrides(cfg: Config) -> Dict:
    """A configuration's ``StepConfig`` fields."""
    return dict(microbatches=cfg["MICROBATCHES"], remat=cfg["REMAT"],
                loss_chunks=cfg["LOSS_CHUNKS"], kv_chunk=cfg["KV_CHUNK"])


def counters_from_record(rec: Dict, hbm_bytes: float,
                         runtime: Optional[float] = None,
                         mem_live: Optional[float] = None
                         ) -> Tuple[CounterSet, bool]:
    """A dry-run record (``lower_cell``'s keys) as a ``CounterSet``, the
    JAX evaluator's mapping under the Hopper names: the roofline bound as
    the runtime (100× when the peak exceeds ``hbm_bytes``) unless a
    measured ``runtime`` is given, the peak live bytes unless a measured
    ``mem_live`` is.  Returns the set and whether it is out of memory."""
    rf = rec["roofline"]
    if mem_live is None:
        mem_live = rec["memory"]["peak_bytes"]
    compute_s, memory_s = rf["compute_s"], rf["memory_s"]
    coll_s = rf["collective_s"]
    oom = mem_live > hbm_bytes
    if runtime is None:
        runtime = max(compute_s, memory_s, coll_s)
        if oom:
            runtime *= OOM_PENALTY  # OOM configs are effectively unrunnable
    ops = {
        C.FP32_FLOPS: rf["flops"] / rec["chips"],
        C.INT_OPS: 0.0,
        C.SFU_OPS: 0.0,
        C.INST_ISSUED: rf["flops"] / rec["chips"],
        C.DRAM_RD: rf["hbm_bytes"] / rec["chips"] * 2 / 3,
        C.DRAM_WR: rf["hbm_bytes"] / rec["chips"] / 3,
        C.SMEM_RD: 0.0, C.SMEM_WR: 0.0, C.CONST_RD: 0.0,
        C.NVLINK_B: rf["collective_bytes"],
        C.CTAS: 64.0,                       # step-level: no grid axis
        C.SMEM_WS: float(mem_live),
        C.LOCAL_B: float(max(0.0, mem_live - hbm_bytes)),
    }
    stress = {
        C.DRAM_U: min(1.0, memory_s / runtime),
        C.SMEM_U: 0.0, C.CONST_U: 0.0,
        C.NVLINK_U: min(1.0, coll_s / runtime),
        C.FP32_U: min(1.0, compute_s / runtime),
        C.INT_U: 0.0, C.SFU_U: 0.0,
        C.ISSUE_U: min(1.0, compute_s / runtime) / 2.0,
        C.SM_E: 1.0, C.WARP_E: 1.0,
        C.OCCUPANCY: min(1.0, mem_live / hbm_bytes),
    }
    return CounterSet(ops=ops, stress=stress, runtime=runtime), oom


class CompiledStepEvaluator(Evaluator):
    """config -> (roofline runtime, counters) via the dry run's count of
    the cell's step.

    Implements the shared evaluator protocol; the ``cost`` charged per
    empirical test is the count's real wall-clock (0 on cache hits).  Each
    test times its own count (the shared ``compile_seconds`` total is
    lock-guarded), so an async search loop that overlaps tests charges
    every test its true cost.  ``config``, a ``ModelConfig``, is counted
    under ``arch_name`` in place of the catalog's.
    """

    def __init__(self, arch_name: str, shape_name: str,
                 hbm_bytes: float = H100_SXM.dram_bytes,
                 verbose: bool = True, config=None):
        super().__init__(make_step_space())
        self.arch_name = arch_name
        self.config = config
        self.shape_name = shape_name
        self.hbm_bytes = hbm_bytes
        self.verbose = verbose
        self._cache: Dict[int, CounterSet] = {}
        self._lock = threading.Lock()
        self.compile_seconds = 0.0

    def _counters_for(self, cfg: Config) -> Tuple[CounterSet, float]:
        from repro_torch.launch import dryrun

        rules_override = None if cfg["FSDP"] else {"embed": None}
        extra = {} if self.config is None else {"config": self.config}
        t0 = time.time()
        rec = dryrun.lower_cell(
            self.arch_name, self.shape_name, multi_pod=False,
            step_overrides=step_overrides(cfg),
            rules_overrides=rules_override,
            verbose=False, **extra,
        )
        compile_s = time.time() - t0
        with self._lock:
            self.compile_seconds += compile_s
        cs, oom = counters_from_record(rec, self.hbm_bytes)
        if self.verbose:
            print(f"  [step-tune] {cfg} -> {cs.runtime*1e3:8.1f}ms"
                  f"{' (OOM)' if oom else ''}")
        return cs, compile_s

    def _evaluate(
        self, idx: int, profiled: bool
    ) -> Tuple[float, CounterSet, float]:
        with self._lock:
            cs = self._cache.get(idx)
        if cs is not None:
            return float(cs.runtime), cs, 0.0
        cs, compile_s = self._counters_for(self.space[idx])
        with self._lock:
            self._cache[idx] = cs
        return float(cs.runtime), cs, compile_s


class MeasuredStepEvaluator(Evaluator):
    """config -> (measured step seconds, counters) from real train steps
    of ``arch_name`` at ``batch`` × ``seq`` on ``device`` (the card unless
    the caller names the CPU, where a step is timed on the host clock and
    the count's peak stands in for the allocator's).

    A test builds the state from ``seed`` (the same parameters every
    test), runs one warm-up step and ``STEPS_TIMED`` timed steps on fixed
    synthetic batches, and returns the median; a profiled test adds the
    op count of the same step.  ``tests`` lists every test's
    configuration, seconds (None when out of memory), peak bytes and the
    timed steps' losses.  ``after``, when set, is called as
    ``after(step, state, batch)`` once a test's steps are timed, before
    its state is freed (a profiler pass over one more step).
    """

    def __init__(self, arch_name: str, batch: int, seq: int, device=None,
                 seed: int = 0, verbose: bool = True):
        from repro_torch.core import hwspec
        from repro_torch.device import resolve_device

        super().__init__(make_step_space())
        self.device = resolve_device(device)
        # the card's own spec prices the count; the CPU stands in for the
        # H100 SXM
        self.hw = hwspec.detect(self.device.index) \
            if self.device.type == "cuda" else H100_SXM
        self.hbm_bytes = self.hw.dram_bytes
        bad = [m for m in self.space.parameters[0].values if batch % m]
        if bad:
            raise ValueError(f"MICROBATCHES {bad} do not divide the batch "
                             f"{batch}")
        self.arch_name = arch_name
        self.batch, self.seq = int(batch), int(seq)
        self.seed = int(seed)
        self.verbose = verbose
        self._cache: Dict[int, Tuple[float, Optional[CounterSet]]] = {}
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.ooms = 0
        self.tests = []
        self.after = None

    # -- one step ---------------------------------------------------------------
    def _record(self, cfg: Config):
        """The dry run's count of this configuration's step as a record
        (one device, ``lower_cell``'s keys)."""
        from repro_torch.launch import dryrun
        from repro_torch.roofline import analysis as roofline
        from repro_torch.train.train_step import StepConfig

        count = dryrun.count_train_step(
            self.arch_name, StepConfig(**step_overrides(cfg)), self.batch,
            self.seq, sharded=bool(cfg["FSDP"]))
        rf = roofline.analyze_count(count, chips=1, hw=self.hw)
        return {"chips": 1, "roofline": rf.summary(),
                "memory": {"peak_bytes": count.peak_bytes}}, count

    def _time_steps(self, cfg: Config
                    ) -> Tuple[float, Optional[float], list]:
        """(median step seconds, peak bytes, the timed steps' losses) of
        this configuration; the peak is None on the CPU."""
        import torch

        from repro_torch.configs import ARCHS
        from repro_torch.data.pipeline import (DataConfig, make_batch,
                                               shard_batch, to_device)
        from repro_torch.distributed.sharding import (batch_shardings,
                                                      default_rules)
        from repro_torch.launch.dryrun import storage_bytes
        from repro_torch.models.registry import build_model
        from repro_torch.optim.adamw import AdamW, warmup_cosine
        from repro_torch.train.train_step import (StepConfig,
                                                  init_train_state,
                                                  make_train_step,
                                                  shard_train_state)

        arch = ARCHS[self.arch_name]
        model = build_model(arch)
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
        scfg = StepConfig(**step_overrides(cfg))
        dcfg = DataConfig(vocab_size=arch.vocab_size, seq_len=self.seq,
                          global_batch=self.batch,
                          frontend=arch.frontend,
                          frontend_len=arch.frontend_len,
                          frontend_dim=arch.frontend_dim)
        hosts = [make_batch(dcfg, i) for i in range(STEPS_TIMED + 1)]
        cuda = self.device.type == "cuda"
        mesh = None
        if cfg["FSDP"]:
            import torch.distributed as dist

            from repro_torch.launch.mesh import make_host_mesh

            mesh = make_host_mesh(1, 1, self.device.type)
        try:
            if cuda:
                torch.cuda.empty_cache()
            state = init_train_state(
                model, opt,
                torch.Generator(device=self.device).manual_seed(self.seed),
                self.device)
            if mesh is not None:
                rules = default_rules(multi_pod=False)
                state = shard_train_state(state, model, mesh, rules)
                batches = [shard_batch(h, batch_shardings(mesh, rules, h))
                           for h in hosts]
                step = make_train_step(model, opt, scfg, mesh=mesh,
                                       rules=rules)
            else:
                batches = [to_device(h, self.device) for h in hosts]
                step = make_train_step(model, opt, scfg)
            state, _ = step(state, batches[0])               # warm-up
            if cuda:
                torch.cuda.synchronize(self.device)
                held = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            seconds, losses = [], []
            for b in batches[1:]:
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state, m = step(state, b)
                    end.record()
                    end.synchronize()
                    seconds.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    state, m = step(state, b)
                    seconds.append(time.perf_counter() - t0)
                losses.append(m["loss"])
            peak = (float(torch.cuda.max_memory_allocated(self.device)
                          - held) + storage_bytes((state, batches[0]))
                    if cuda else None)
            losses = [float(x) for x in losses]
            if self.after is not None:
                self.after(step, state, batches[1])
            return statistics.median(seconds), peak, losses
        finally:
            state = batches = step = None
            if mesh is not None:
                dist.destroy_process_group()
            if cuda:
                torch.cuda.empty_cache()

    def _measure(self, cfg: Config, profiled: bool
                 ) -> Tuple[float, Optional[CounterSet]]:
        import torch

        oom, losses = False, []
        try:
            seconds, peak, losses = self._time_steps(cfg)
        except torch.cuda.OutOfMemoryError:
            oom, seconds, peak = True, None, None
        rec = count = None
        if profiled or oom or peak is None:
            rec, count = self._record(cfg)
        cs = None
        if oom:
            self.ooms += 1
            bound = max(rec["roofline"][k] for k in
                        ("compute_s", "memory_s", "collective_s"))
            runtime = bound * OOM_PENALTY
            cs, _ = counters_from_record(rec, self.hbm_bytes, runtime,
                                         max(rec["memory"]["peak_bytes"],
                                             self.hbm_bytes))
        else:
            runtime = seconds
            if rec is not None:
                cs, _ = counters_from_record(
                    rec, self.hbm_bytes, runtime,
                    peak if peak is not None else count.peak_bytes)
        self.tests.append({"config": dict(cfg), "seconds": seconds,
                           "peak_bytes": peak if peak is not None
                           else count.peak_bytes, "losses": losses})
        if self.verbose:
            what = "OOM" if oom else f"{seconds*1e3:8.1f}ms"
            print(f"  [step-tune] {cfg} -> {what}")
        return runtime, (cs if profiled else None)

    def _evaluate(self, idx: int, profiled: bool
                  ) -> Tuple[float, Optional[CounterSet], float]:
        with self._lock:
            hit = self._cache.get(idx)
        if hit is not None and (hit[1] is not None or not profiled):
            return hit[0], hit[1], 0.0
        t0 = time.perf_counter()
        runtime, cs = self._measure(self.space[idx], profiled)
        cost = time.perf_counter() - t0
        with self._lock:
            self.seconds += cost
            self._cache[idx] = (runtime, cs)
        return runtime, cs, cost
