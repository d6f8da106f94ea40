"""Online shape-bucketed autotuning for the serving engine.

The paper's motivation (ii): autotuning must be *repeated* whenever the
processed-data characteristics change, and a portable TP→PC_ops model makes
each repetition cheap.  A serving engine under load is exactly that scenario:
the live request mix (prompt length × generation length) shifts over time,
and the best (batch size, cache length) engine configuration shifts with it.

The JAX package's ``repro.serve.autotune`` carried over.  The workload
model is the JAX package's number for number, its counters under the
port's Hopper names (``counters.TPU_NAMES``), TPU-shaped terms included;
the port has no production TPU, so ``hw`` defaults to ``hwspec.H100_SXM``
and ``launch/serve.py`` passes the spec detected for the card.

* ``ShapeBucketer`` — maps requests into decile buckets of the serving range
  (prompt-length decile × max-new-tokens decile); a bucket is the "input" of
  the paper's ``g : TP × I → PC_ops``.
* ``serve_workload_fn`` — the portable workload model for one serving tick:
  hardware-independent operation counts (weight streaming, KV traffic,
  matrix work, working set) as a function of the engine configuration.
* ``OnlineAutotuner`` — watches the live mix through a sliding window,
  declares **drift** when the dominant bucket leaves the bucket the active
  configuration was tuned for, and then either *reuses* a configuration from
  the persistent ``ConfigStore`` (zero live trials) or *retunes* with a
  handful of live wave-latency trials, warm-started from the portable
  model's predicted-runtime ranking (``warm_start`` searcher +
  ``FunctionEvaluator`` over real wave latencies).  Freshly tuned configs
  and trained model artifacts are written back to the store.
* ``EngineBackend`` / ``SyntheticServeBackend`` — the live measurement
  substrate: a cache of warmed ``ServeEngine``s on a device (waves timed
  with the card's queue drained at both ends, under its timing lock), and
  a deterministic cost-model-backed fake (virtual clock, seeded jitter)
  for benchmarks and golden tests.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core import counters as C
from repro_torch.core.evaluate import FunctionEvaluator
from repro_torch.core.hwspec import H100_SXM, HardwareSpec, hardware_key
from repro_torch.core.searcher import WarmStartSearcher, run_search
from repro_torch.core.tuner import predicted_runtimes
from repro_torch.core.tuning_space import (Config, TuningParameter,
                                           TuningSpace)
from repro_torch.serve.engine import Request, ServeEngine, timed_generate
from repro_torch.tuning.problem import TuningProblem
from repro_torch.tuning.session import TuningSession
from repro_torch.tuning.store import ConfigStore, StoreEntry

SPACE_NAME = "serve_online"
# latency charged to configurations that cannot hold the bucket's sequences
INFEASIBLE_S = 1e3


# =============================================================================
# Shape buckets
# =============================================================================
@dataclasses.dataclass(frozen=True)
class Bucket:
    """One input-shape class: (prompt-length decile, max-new decile)."""

    prompt_decile: int
    new_decile: int

    @property
    def key(self) -> str:
        return f"p{self.prompt_decile}n{self.new_decile}"


class ShapeBucketer:
    """Decile bucketing of the serving shape range.

    ``max_prompt`` / ``max_new`` define the range the deciles partition;
    requests beyond the range land in the top decile.  The *representative*
    shape of a bucket is its upper decile edge — the worst case a
    configuration tuned for the bucket must accommodate.
    """

    def __init__(self, max_prompt: int = 96, max_new: int = 32):
        if max_prompt <= 0 or max_new <= 0:
            raise ValueError("bucketer ranges must be positive")
        self.max_prompt = int(max_prompt)
        self.max_new = int(max_new)

    def bucket_of(self, prompt_len: int, max_new_tokens: int) -> Bucket:
        pd = min(9, (10 * max(0, int(prompt_len))) // self.max_prompt)
        nd = min(9, (10 * max(0, int(max_new_tokens))) // self.max_new)
        return Bucket(prompt_decile=pd, new_decile=nd)

    def request_bucket(self, r: Request) -> Bucket:
        return self.bucket_of(len(r.prompt), r.max_new_tokens)

    def rep_shape(self, b: Bucket) -> Tuple[int, int]:
        """(prompt_len, new_tokens) at the bucket's upper decile edge."""
        plen = max(1, math.ceil((b.prompt_decile + 1) * self.max_prompt / 10))
        new = max(1, math.ceil((b.new_decile + 1) * self.max_new / 10))
        return plen, new


# =============================================================================
# The tuning space and the portable workload model
# =============================================================================
def serve_space(batch_sizes: Sequence[int] = (1, 2, 4, 8, 16),
                max_seqs: Sequence[int] = (32, 64, 96, 128, 192),
                name: str = SPACE_NAME) -> TuningSpace:
    """Engine configurations the online tuner searches over."""
    return TuningSpace(
        [TuningParameter("BATCH", tuple(int(b) for b in batch_sizes)),
         TuningParameter("MAX_SEQ", tuple(int(s) for s in max_seqs))],
        name=name)


@dataclasses.dataclass(frozen=True)
class ServeWorkloadStats:
    """Model-architecture constants the serving workload model needs."""

    param_bytes: float = 2e9     # streamed weight bytes per decode step
    d_model: int = 4096
    n_layers: int = 24
    bytes_per_value: int = 2     # bf16

    @property
    def kv_bytes_per_pos(self) -> float:
        """K+V cache bytes per sequence position, all layers."""
        return 2.0 * self.n_layers * self.d_model * self.bytes_per_value


def stats_from_model(model, bytes_per_value: int = 2) -> ServeWorkloadStats:
    """Derive workload stats from a real model-zoo ``Model``."""
    cfg = model.cfg
    return ServeWorkloadStats(
        param_bytes=float(model.param_count()) * bytes_per_value,
        d_model=int(cfg.d_model),
        n_layers=int(cfg.n_layers),
        bytes_per_value=bytes_per_value)


def serve_workload_fn(n_requests: int, prompt_len: int, new_tokens: int,
                      stats: ServeWorkloadStats
                      ) -> Callable[[Config], Dict[str, float]]:
    """``g : TP × I → PC_ops`` for one serving tick (hardware-independent).

    The input ``I`` is the shape bucket (``prompt_len``/``new_tokens`` at the
    bucket's representative edge) plus the tick size.  The counters capture
    the first-order serving physics: every decode step streams the weights
    once per wave and touches the KV prefix (so fewer waves — bigger BATCH —
    amortize weight reads, while an oversized MAX_SEQ inflates cache
    traffic), and the per-program working set grows with BATCH × MAX_SEQ
    (so the cost model's spill/double-buffer logic penalizes configurations
    that oversubscribe this hardware's shared memory — the cache-capacity
    effect that makes the best config hardware-dependent).
    """
    n = max(1, int(n_requests))
    plen = max(1, int(prompt_len))
    steps = max(1, int(new_tokens))
    flops_per_tok = 2.0 * stats.param_bytes / stats.bytes_per_value
    kv_pos = stats.kv_bytes_per_pos

    def wl(cfg: Config) -> Dict[str, float]:
        b = int(cfg["BATCH"])
        ms = int(cfg["MAX_SEQ"])
        waves = math.ceil(n / b)
        tok_total = n * (plen + steps)
        hbm_rd = waves * steps * (stats.param_bytes + 0.5 * b * ms * kv_pos)
        hbm_wr = waves * (plen + steps) * b * kv_pos / max(1, stats.n_layers)
        mxu = tok_total * flops_per_tok
        vpu = tok_total * 24.0 * stats.d_model * stats.n_layers
        issue = mxu / 128.0 + vpu
        ws = (2.0 * stats.d_model * stats.d_model * stats.bytes_per_value
              + b * ms * kv_pos / stats.n_layers * 8.0)
        return {
            C.DRAM_RD: float(hbm_rd),
            C.DRAM_WR: float(hbm_wr),
            C.SMEM_RD: float(2.0 * hbm_rd),
            C.SMEM_WR: float(2.0 * hbm_wr),
            C.FP32_FLOPS: float(mxu),
            C.INT_OPS: float(vpu),
            C.INST_ISSUED: float(issue),
            C.CTAS: float(b * stats.n_layers),
            C.SMEM_WS: float(ws),
        }

    return wl


# =============================================================================
# The serve problem (registry kind "serve")
# =============================================================================
class ServeProblem(TuningProblem):
    """Serving wave geometry (BATCH × MAX_SEQ) for one shape bucket.

    The problem name is the bucket key (``"p9n9"``): prompt-length decile
    × max-new decile of the serving range, resolved to its representative
    shape by ``ShapeBucketer``.  ``make_evaluator`` prices the portable
    serving workload through the cost model with configurations that
    cannot hold the bucket's sequences charged ``INFEASIBLE_S`` — the
    exact semantics the daemon's serve-kind special case hard-coded
    before this class replaced it.

    Workload-model constants come either from explicit ``stats`` (a
    ``ServeWorkloadStats`` or its dict form — the service wire format) or
    from a model-zoo entry via ``arch=`` (closed-form parameter count, no
    model built).
    """

    kind = "serve"

    def __init__(self, bucket: str, batch_sizes: Sequence[int] = None,
                 max_seqs: Sequence[int] = None, space_name: str = SPACE_NAME,
                 calib_n: int = 16, stats=None, arch: Optional[str] = None,
                 max_prompt: int = 96, max_new: int = 32,
                 shape: Optional[Tuple[int, int]] = None):
        b = _parse_bucket(bucket)
        if stats is not None and arch is not None:
            raise ValueError("pass stats= or arch=, not both")
        if isinstance(stats, dict):
            allowed = {f.name for f in dataclasses.fields(ServeWorkloadStats)}
            bad = set(stats) - allowed
            if bad:
                raise ValueError(f"unknown stats fields {sorted(bad)}")
            stats = ServeWorkloadStats(**stats)
        if arch is not None:
            stats = stats_from_arch(arch)
        self.stats = stats if stats is not None else ServeWorkloadStats()
        self.bucketer = ShapeBucketer(max_prompt=max_prompt, max_new=max_new)
        self._bucket = b
        self.bucket = b.key
        self.name = b.key
        self.calib_n = int(calib_n)
        # explicit (prompt_len, new_tokens) override: the service path
        # measures at the CLIENT's representative shape, whatever its
        # bucketer's deciles resolve to, not this problem's default
        self._shape = (int(shape[0]), int(shape[1])) \
            if shape is not None else None
        self._space = serve_space(
            batch_sizes if batch_sizes is not None else (1, 2, 4, 8, 16),
            max_seqs if max_seqs is not None else (32, 64, 96, 128, 192),
            name=space_name)

    @classmethod
    def from_name(cls, name: str, **params) -> "ServeProblem":
        return cls(name, **params)

    @property
    def rep_shape(self) -> Tuple[int, int]:
        """(prompt_len, new_tokens) at the bucket's upper decile edge
        (or the explicit ``shape=`` override)."""
        if self._shape is not None:
            return self._shape
        return self.bucketer.rep_shape(self._bucket)

    def space(self) -> TuningSpace:
        return self._space

    def workload_fn(self) -> Callable[[Config], Dict[str, float]]:
        plen, new = self.rep_shape
        return serve_workload_fn(self.calib_n, plen, new, self.stats)

    def make_evaluator(self, hw: HardwareSpec) -> Optional[Callable]:
        from repro_torch.core.evaluate import (PROFILE_FIXED,
                                               PROFILE_SLOWDOWN,
                                               TEST_OVERHEAD)
        space, wl = self._space, self.workload_fn()
        plen, new = self.rep_shape
        need = plen + new

        def fn(index: int, profile: bool):
            cfg = space[int(index)]
            cs = costmodel.execute(wl(cfg), hw)
            rt = INFEASIBLE_S if int(cfg["MAX_SEQ"]) < need \
                else float(cs.runtime)
            if profile:
                return rt, cs, rt * PROFILE_SLOWDOWN + TEST_OVERHEAD \
                    + PROFILE_FIXED
            return rt, None, rt + TEST_OVERHEAD

        return fn


_BUCKET_RE = re.compile(r"^p(\d)n(\d)$")


def _parse_bucket(key: str) -> Bucket:
    m = _BUCKET_RE.match(str(key))
    if not m:
        raise ValueError(
            f"serve problem name must be a bucket key 'p<0-9>n<0-9>', "
            f"got {key!r}")
    return Bucket(prompt_decile=int(m.group(1)), new_decile=int(m.group(2)))


def stats_from_arch(arch: str, bytes_per_value: int = 2
                    ) -> ServeWorkloadStats:
    """Workload stats from a model-zoo entry WITHOUT building the model
    (closed-form parameter count: no model is built)."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.tuning import arch_param_count
    if arch not in ARCHS:
        raise KeyError(f"unknown model-zoo entry {arch!r}; available: "
                       f"{sorted(ARCHS)}")
    cfg = ARCHS[arch]
    return ServeWorkloadStats(
        param_bytes=float(arch_param_count(cfg)) * bytes_per_value,
        d_model=int(cfg.d_model), n_layers=int(cfg.n_layers),
        bytes_per_value=bytes_per_value)


# =============================================================================
# Live-measurement backends
# =============================================================================
def _tick_shape(requests: Sequence[Request]) -> Tuple[int, int, int]:
    """(n, max prompt len, max new tokens) of a request batch."""
    n = len(requests)
    plen = max((len(r.prompt) for r in requests), default=1)
    new = max((max(0, r.max_new_tokens) for r in requests), default=1)
    return n, max(1, plen), max(1, new)


class EngineBackend:
    """Real serving backend: warmed ``ServeEngine``s on ``device`` (the
    card unless the caller names the CPU) cached per (batch, max_seq), all
    sharing ONE parameter set (``model.init`` runs once, not per trial
    configuration).  Before a timed measurement the engine warms every
    wave size the request count implies (full batch + partial tail), so
    ``measure`` never times the first wave's library loads; the wave is
    timed with the card's queue drained before the clock starts and
    before it is read, under the card's timing lock
    (``serve.engine.timed_generate``).  ``serve`` bumps the cache length
    when a request would not fit the tuned configuration."""

    def __init__(self, model, generator=None, warmup: bool = True,
                 seq_round: int = 32, device=None, params=None):
        from repro_torch.device import resolve_device

        self.model = model
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(
            generator, device=self.device)
        self.do_warmup = warmup
        self.seq_round = int(seq_round)
        self.engines: Dict[Tuple[int, int], ServeEngine] = {}
        self._warmed: Dict[Tuple[int, int], set] = {}
        self.measure_calls = 0

    def _engine(self, batch: int, max_seq: int,
                n_requests: Optional[int] = None) -> ServeEngine:
        key = (int(batch), int(max_seq))
        if key not in self.engines:
            self.engines[key] = ServeEngine(
                self.model, batch_size=key[0], max_seq=key[1],
                params=self.params, device=self.device)
            self._warmed[key] = set()
        eng = self.engines[key]
        if self.do_warmup and n_requests is not None:
            n = max(1, int(n_requests))
            sizes = {min(key[0], n)}
            if n % key[0]:
                sizes.add(n % key[0])
            for size in sorted(sizes - self._warmed[key]):
                eng.warmup(wave_size=size)
                self._warmed[key].add(size)
        return eng

    def _fit_seq(self, cfg: Config, requests: Sequence[Request]) -> int:
        _, plen, new = _tick_shape(requests)
        need = plen + new
        ms = int(cfg["MAX_SEQ"])
        if need > ms:  # oversize stragglers: round up, keep the cache small
            ms = math.ceil(need / self.seq_round) * self.seq_round
        return ms

    def measure(self, cfg: Config, requests: Sequence[Request]) -> float:
        """Timed wave latency of ``requests`` under ``cfg`` (one live
        empirical test, warmed engine, seconds)."""
        _, plen, new = _tick_shape(requests)
        if plen + new > int(cfg["MAX_SEQ"]):
            return INFEASIBLE_S
        self.measure_calls += 1
        engine = self._engine(int(cfg["BATCH"]), int(cfg["MAX_SEQ"]),
                              n_requests=len(requests))
        return timed_generate(engine, [dataclasses.replace(r, generated=None)
                                       for r in requests])

    def serve(self, cfg: Config, requests: Sequence[Request]
              ) -> Dict[int, List[int]]:
        engine = self._engine(int(cfg["BATCH"]), self._fit_seq(cfg, requests))
        return engine.generate(list(requests))


class SyntheticServeBackend:
    """Deterministic fake serving backend (virtual clock, no device).

    Wave latency = the analytic cost model on the *true* hardware spec, over
    a skewed copy of the portable workload's counters (the model never sees
    the skew), plus per-wave host overhead and a seeded shape/config-keyed
    jitter — so warm-start rankings are good-but-imperfect, exactly the
    regime the ≤K-live-trials design targets.  Used by the shifting-workload
    benchmark and the golden ask-tell trace tests.
    """

    def __init__(self, hw: HardwareSpec, stats: ServeWorkloadStats,
                 noise: float = 0.05, host_overhead_s: float = 1.5e-3,
                 hbm_skew: float = 1.12, seed: int = 0,
                 seq_round: int = 32):
        self.hw = hw
        self.stats = stats
        self.noise = float(noise)
        self.host_overhead_s = float(host_overhead_s)
        self.hbm_skew = float(hbm_skew)
        self.seed = int(seed)
        self.seq_round = int(seq_round)
        self.measure_calls = 0
        self.serve_calls = 0
        self.virtual_time = 0.0

    def latency(self, cfg: Config, n: int, plen: int, new: int) -> float:
        """Pure deterministic latency — also the oracle's measurement."""
        b, ms = int(cfg["BATCH"]), int(cfg["MAX_SEQ"])
        if plen + new > ms:
            return INFEASIBLE_S
        ops = serve_workload_fn(n, plen, new, self.stats)(cfg)
        ops[C.DRAM_RD] = ops[C.DRAM_RD] * self.hbm_skew
        base = costmodel.execute(ops, self.hw).runtime
        waves = math.ceil(max(1, n) / b)
        rng = np.random.default_rng([self.seed, b, ms, n, plen, new])
        jitter = (2.0 * rng.random() - 1.0) * self.noise
        return base * (1.0 + jitter) + waves * self.host_overhead_s

    def measure(self, cfg: Config, requests: Sequence[Request]) -> float:
        self.measure_calls += 1
        return self.latency(cfg, *_tick_shape(requests))

    def serve(self, cfg: Config, requests: Sequence[Request]
              ) -> Dict[int, List[int]]:
        self.serve_calls += 1
        n, plen, new = _tick_shape(requests)
        ms = int(cfg["MAX_SEQ"])
        if plen + new > ms:  # mirror EngineBackend._fit_seq: bump, don't fail
            ms = math.ceil((plen + new) / self.seq_round) * self.seq_round
        self.virtual_time += self.latency({**cfg, "MAX_SEQ": ms}, n, plen,
                                          new)
        return {r.uid: [0] * max(0, r.max_new_tokens) for r in requests}


# =============================================================================
# The online tuner
# =============================================================================
@dataclasses.dataclass
class TickReport:
    """What one ``serve`` call did: which bucket dominated, whether the mix
    drifted, and how the active configuration was (re)established."""

    bucket: str
    drift: bool
    reused: bool                 # config came from the store, 0 live trials
    live_trials: int
    config: Config
    history: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    via_service: bool = False    # tuned remotely by the tuning daemon


class OnlineAutotuner:
    """Drift-triggered, store-backed autotuning around a serving backend.

    Flow per ``serve(requests)`` tick:

    1. bucket every request; extend the sliding shape window; the window's
       dominant bucket is the current mix;
    2. **drift** when the dominant bucket differs from the bucket the active
       configuration was tuned for (or nothing is active yet);
    3. on drift, consult the ``ConfigStore`` under ``(space name, bucket,
       hardware)`` — a hit reuses the stored config with zero live trials; a
       miss runs at most ``max_live_trials`` live wave-latency measurements
       through the ask-tell API (``warm_start`` searcher ordered by the
       portable model's predicted runtimes on the target hardware +
       ``FunctionEvaluator``), then persists the winner and the model
       artifact;
    4. serve the tick through the backend with the active configuration.

    ``hw`` is the (virtual) hardware of interest: it prices the model's
    PC_ops predictions into the warm-start ranking.  ``train_hw`` makes the
    cross-hardware training scenario explicit (default: train on ``hw``).
    """

    def __init__(
        self,
        backend,
        store: Optional[ConfigStore] = None,
        bucketer: Optional[ShapeBucketer] = None,
        space: Optional[TuningSpace] = None,
        hw: HardwareSpec = H100_SXM,
        train_hw: Optional[HardwareSpec] = None,
        stats: Optional[ServeWorkloadStats] = None,
        hardware_name: Optional[str] = None,
        max_live_trials: int = 8,
        window: int = 32,
        calib_n: int = 16,
        model_kind: str = "tree",
        in_flight: int = 1,
        seed: int = 0,
        service: Optional[Any] = None,
        service_tenant: str = "serve",
        service_timeout: float = 120.0,
    ):
        self.backend = backend
        self.store = store if store is not None else ConfigStore()
        self.bucketer = bucketer if bucketer is not None else ShapeBucketer()
        self.space = space if space is not None else serve_space()
        self.hw = hw
        self.train_hw = train_hw if train_hw is not None else hw
        self.stats = stats if stats is not None else ServeWorkloadStats()
        # normalized so store hits survive naming drift ("H100-SXM" ==
        # "h100_sxm")
        self.hardware_name = hardware_key(
            hardware_name if hardware_name is not None else hw)
        self.max_live_trials = int(max_live_trials)
        # outstanding live trials kept in flight by the async search loop
        # (1 = sequential; >1 pays off once the backend measures async)
        self.in_flight = int(in_flight)
        self.calib_n = int(calib_n)
        self.model_kind = model_kind
        self.seed = int(seed)
        self._window: deque = deque(maxlen=int(window))
        self._seen: Dict[str, Bucket] = {}
        self._models: Dict[str, Any] = {}
        self._active: Optional[StoreEntry] = None
        self.reports: List[TickReport] = []
        # optional tuning-as-a-service routing: a daemon address
        # ("host:port" / (host, port)) or a ready ServiceClient.  Drift
        # retunes are tried through the daemon first (sharing its fleet,
        # corpus and budgets) and fall back to in-process live trials
        # whenever it is unreachable or refuses the request.
        self.service = service
        self.service_tenant = service_tenant
        self.service_timeout = float(service_timeout)
        self._service_client: Optional[Any] = None
        self._via_service = False

    # -- portable model / ranking ---------------------------------------------
    def _session_for(self, bucket: Bucket) -> TuningSession:
        plen, new = self.bucketer.rep_shape(bucket)
        wl = serve_workload_fn(self.calib_n, plen, new, self.stats)
        return TuningSession(self.space, wl, hw=self.hw, seed=self.seed)

    def _model_for(self, bucket: Bucket):
        model = self._models.get(bucket.key)
        if model is not None:
            return model
        session = self._session_for(bucket)
        model = session.load_model_from_store(self.store, bucket.key,
                                              self.hardware_name,
                                              kind="serve")
        if model is None:
            # train the portable TP→PC_ops model (on train_hw — possibly a
            # different machine than the one being tuned) and persist it
            session.train(train_hw=self.train_hw, kind=self.model_kind,
                          sample="full")
            session.save_model_to_store(self.store, bucket.key,
                                        self.hardware_name, kind="serve")
            model = session.model
        self._models[bucket.key] = model
        return model

    def ranking(self, bucket: Bucket, min_seq: Optional[int] = None
                ) -> List[int]:
        """Feasible config indices, best-predicted first: the model's PC_ops
        predictions priced through the cost model on the target hardware.

        ``min_seq`` raises the feasibility bar beyond the bucket's
        representative edge — requests clamped into the top decile can be
        longer than the edge, and tuning must only consider configurations
        the live calibration wave actually fits in.
        """
        model = self._model_for(bucket)
        pred_rt = predicted_runtimes(model, self.space, self.hw)
        plen, new = self.bucketer.rep_shape(bucket)
        need = max(plen + new, min_seq if min_seq is not None else 0)
        order = [int(i) for i in np.argsort(pred_rt, kind="stable")
                 if int(self.space[int(i)]["MAX_SEQ"]) >= need]
        if not order:
            raise ValueError(
                f"no feasible config in {self.space.name!r} for bucket "
                f"{bucket.key} (needs MAX_SEQ >= {need})")
        return order

    # -- tuning ----------------------------------------------------------------
    def _tune_via_service(self, bucket: Bucket) -> Optional[StoreEntry]:
        """Ask the tuning daemon to tune this bucket; ``None`` = fall back.

        The submit describes the client's exact tuning problem (same
        space name and parameter grid, the bucket's representative
        shape, the workload-model constants), so the daemon's fleet
        answers with a config valid here and publishes artifacts future
        clients warm-start from.  Any transport or service refusal —
        daemon down, admission denied, tenant budget exhausted, request
        cancelled by a daemon drain — degrades to in-process tuning.
        """
        if self.service is None:
            return None
        from repro_torch.service.client import ServiceClient, ServiceError
        try:
            if self._service_client is None:
                self._service_client = self.service \
                    if hasattr(self.service, "submit_serve") \
                    else ServiceClient(self.service,
                                       timeout=self.service_timeout)
            client = self._service_client
            plen, new = self.bucketer.rep_shape(bucket)
            by_name = {p.name: list(p.values) for p in self.space.parameters}
            # a hardware label outside the spec registry (e.g. a replica
            # running on "cpu") ships its pricing spec's numbers so the
            # daemon can still cost the space — the fleet's lane idiom
            from repro_torch.core import hwspec
            try:
                hwspec.get(self.hardware_name)
                spec_payload = None
            except KeyError:
                spec_payload = dataclasses.asdict(self.hw)
            resp = client.submit_serve(
                tenant=self.service_tenant,
                hardware=self.hardware_name,
                bucket=bucket.key, bucket_shape=[plen, new],
                batch_sizes=by_name["BATCH"], max_seqs=by_name["MAX_SEQ"],
                space=self.space.name, calib_n=self.calib_n,
                stats=dataclasses.asdict(self.stats),
                budget=self.max_live_trials, seed=self.seed,
                hardware_spec=spec_payload)
            if resp["state"] == "done":     # store hit on the daemon side
                res = resp
            else:
                res = client.result(resp["request_id"],
                                    timeout=self.service_timeout)
        except (ServiceError, TimeoutError, OSError):
            self._service_client = None     # reconnect lazily next drift
            return None
        # adopt locally so subsequent drifts back to this bucket are pure
        # local store hits (and survive daemon restarts)
        return self.store.put(
            self.space.name, bucket.key, self.hardware_name,
            config=dict(res["config"]), runtime=float(res["runtime"]),
            trials=int(res.get("trials", 0)),
            meta={"source": res.get("source", "service"),
                  "service": True, "bucket_shape": list(
                      self.bucketer.rep_shape(bucket))},
            kind="serve")

    def ensure(self, bucket: Bucket, calib: Sequence[Request]
               ) -> Tuple[StoreEntry, int, bool]:
        """Return (entry, live_trials, reused) for ``bucket`` — store hit is
        pure reuse (0 live trials); a miss asks the tuning service (when
        configured), and failing that tunes live and persists."""
        self._via_service = False
        entry = self.store.get(self.space.name, bucket.key,
                               self.hardware_name, kind="serve")
        if entry is not None:
            return entry, 0, True
        entry = self._tune_via_service(bucket)
        if entry is not None:
            self._via_service = True
            return entry, 0, False
        _, calib_plen, calib_new = _tick_shape(calib)
        order = self.ranking(bucket, min_seq=calib_plen + calib_new)
        ev = FunctionEvaluator(
            self.space, lambda cfg: self.backend.measure(cfg, calib))
        searcher = WarmStartSearcher(self.space, order=order, seed=self.seed)
        run_search(searcher, ev, min(self.max_live_trials, len(order)),
                   in_flight=self.in_flight)
        plen, new = self.bucketer.rep_shape(bucket)
        entry = self.store.put(
            self.space.name, bucket.key, self.hardware_name,
            config=self.space[ev.best_index],
            runtime=ev.best_runtime, trials=ev.steps,
            meta={"history": [[int(i), float(rt)] for i, rt in ev.history()],
                  "bucket_shape": [plen, new]},
            kind="serve")
        return entry, ev.steps, False

    # -- the serving loop ------------------------------------------------------
    def serve(self, requests: Sequence[Request]
              ) -> Tuple[Dict[int, List[int]], Optional[TickReport]]:
        """Serve one tick: detect drift, (re)tune or reuse, then generate."""
        if not requests:
            return {}, None
        buckets = [self.bucketer.request_bucket(r) for r in requests]
        self._seen.update({b.key: b for b in buckets})
        self._window.extend(b.key for b in buckets)
        counts = Counter(self._window)
        dom_key = max(sorted(counts), key=lambda k: counts[k])
        dom = self._seen[dom_key]
        drift = self._active is None or self._active.bucket != dom_key
        live, reused, history = 0, False, []
        if drift:
            calib = [r for r, b in zip(requests, buckets)
                     if b.key == dom_key][: self.calib_n]
            if not calib:
                calib = list(requests)[: self.calib_n]
            entry, live, reused = self.ensure(dom, calib)
            history = [tuple(h) for h in entry.meta.get("history", [])] \
                if not reused else []
            self._active = entry
        outputs = self.backend.serve(self._active.config, requests)
        report = TickReport(bucket=dom_key, drift=drift, reused=reused,
                            live_trials=live, config=dict(self._active.config),
                            history=history,
                            via_service=drift and self._via_service)
        self.reports.append(report)
        return outputs, report

    @property
    def drift_events(self) -> List[TickReport]:
        return [r for r in self.reports if r.drift]
