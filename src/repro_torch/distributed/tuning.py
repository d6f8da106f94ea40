"""``ShardingProblem`` — train-step sharding layouts as a ``TuningProblem``:
the JAX package's ``repro.distributed.tuning`` carried over.

The tuning space is the distribution configuration of one model-zoo entry
on a fixed chip count: mesh factorization (data × model), FSDP on/off
(shard the optimizer state over the data axis), sequence sharding on/off
(shard activations over the model axis) and gradient-accumulation
microbatches.  These are the knobs ``distributed/sharding.py``'s
``ShardingRules`` and the sharded train step
(``repro_torch.train.train_step.make_train_step(mesh=...)``) expose.

The portable workload model (``g : TP × I → PC_ops``) derives first-order
per-device counters in closed form from the ``ArchConfig`` (parameter,
activation and collective arithmetic), so the fleet, store and TP→PC model
treat a sharding layout exactly like a kernel tile.  The counters are the
port's Hopper names (``FP32_FLOPS`` for the JAX ``MXU_FLOPS``,
``NVLINK_B`` for ``ICI_B``, ``LOCAL_B`` for ``SPILL_B``, …:
``core.counters.FROM_TPU_NAMES``), and their arithmetic is the JAX
package's, constant for constant, so that the two packages' problems agree
value for value:

* tensor parallelism pays ring-all-reduce link volume per layer but
  divides the weight-stream and optimizer-state footprint;
* the MLP shard ``d_ff/m`` pads to the reference package's 256-lane
  granularity, counted as extra effective ``FP32_FLOPS``;
* without FSDP the full optimizer state must be resident per model shard;
  oversubscribing the reference package's device memory shows up as
  ``LOCAL_B`` traffic;
* sequence sharding divides activation residency/traffic/integer work by
  the model degree at no extra link volume;
* the per-layer working set (activation tile + MLP weight shard) decides
  whether the cost model grants DMA/compute double buffering.

The constants below (``REF_HBM_BYTES``, ``LANE_GRAN``, ``TILE_TOKENS``)
are the reference package's values, kept so that the port is held to it
bit for bit; they describe no card.  Pricing the layouts for the H100
(80 GB, NVLink, no lane padding) is ROADMAP.md, queue 1, item 1.

``make_evaluator(hw)`` prices a skewed copy of the counters (the model
never sees the skew) plus seeded config-keyed jitter, the JAX package's
analytic backend.  ``backend="compiled"`` counts the real train step per
configuration through the dry run (``launch.dryrun.lower_cell``: rank 0's
ops on fake tensors on the 16×16 fake mesh) and prices its roofline at
the H100's rates; the production mesh fixes the chip layout, so only the
rules knobs (FSDP, SEQ, the model axis) and GA vary there.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core import counters as C
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.tuning_space import Config, TuningParameter, TuningSpace
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.tuning.problem import TuningProblem

# The reference package's constants, kept as they are there (they
# describe no card; the H100's pricing is ROADMAP.md, queue 1, item 1).
# Bytes per parameter of resident training state: bf16 param + bf16 grad
# + 2x fp32 Adam moments.
STATE_BYTES_PER_PARAM = 12.0
# Reference device-memory capacity the *portable* oversubscription counter
# is taken against (the cost model recomputes hardware-true shared-memory
# spill; capacity has no portable analog, so the workload reports pressure
# against a fixed reference — the paper's §3.1 imprecision note applies).
REF_HBM_BYTES = 16e9
# Lane granularity the MLP shard pads to (the reference's 256-wide lanes).
LANE_GRAN = 256
# Activation tokens one grid program processes (working-set tile).
TILE_TOKENS = 2048
BYTES = 2.0  # bf16 activations/params on the wire


def mesh_factorizations(n_devices: int) -> List[str]:
    """All power-of-2 ``"<data>x<model>"`` splits of ``n_devices``."""
    n = int(n_devices)
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n_devices must be a power of 2, got {n_devices}")
    out = []
    m = 1
    while m <= n:
        out.append(f"{n // m}x{m}")
        m *= 2
    return out


def parse_mesh(value: str) -> Tuple[int, int]:
    """``"8x8"`` → ``(data, model)`` extents."""
    d, _, m = str(value).partition("x")
    return int(d), int(m)


def sharding_space(n_devices: int, name: str) -> TuningSpace:
    """MESH × FSDP × SEQ × GA, with the no-op corners constrained away
    (FSDP needs a data axis to shard over; SEQ needs a model axis).
    ``GA`` is the gradient-accumulation microbatch count: it divides live
    activation residency (spill relief) at the price of re-streaming the
    fp32 accumulator shard per extra microbatch and more grid programs."""
    return TuningSpace(
        [TuningParameter("MESH", tuple(mesh_factorizations(n_devices))),
         TuningParameter("FSDP", (0, 1)),
         TuningParameter("SEQ", (0, 1)),
         TuningParameter("GA", (1, 2, 4))],
        constraints=(
            lambda c: not (c["FSDP"] and parse_mesh(c["MESH"])[0] == 1),
            lambda c: not (c["SEQ"] and parse_mesh(c["MESH"])[1] == 1),
        ),
        name=name)


# =============================================================================
# jax-free architecture arithmetic
# =============================================================================
def arch_param_count(cfg: ArchConfig) -> float:
    """Closed-form parameter count of a model-zoo entry (all experts)."""
    q = cfg.n_heads * cfg.eff_head_dim
    kv = cfg.n_kv_heads * cfg.eff_head_dim
    attn = cfg.d_model * q + 2.0 * cfg.d_model * kv + q * cfg.d_model
    d_ff = cfg.moe_d_ff or cfg.d_ff
    if cfg.n_experts > 0:
        mlp = (cfg.n_experts + cfg.n_shared_experts) * 3.0 * cfg.d_model \
            * d_ff + cfg.d_model * cfg.n_experts  # router
    else:
        mlp = 3.0 * cfg.d_model * cfg.d_ff
    norms = 2.0 * cfg.d_model
    embed = cfg.padded_vocab * cfg.d_model \
        * (1.0 if cfg.tie_embeddings else 2.0)
    return cfg.n_layers * (attn + mlp + norms) + embed + cfg.d_model


def arch_active_param_count(cfg: ArchConfig) -> float:
    """Parameters a token actually touches (MoE: ``top_k`` experts)."""
    if cfg.n_experts <= 0:
        return arch_param_count(cfg)
    active = cfg.scaled(n_experts=max(1, cfg.top_k))
    return arch_param_count(active)


# =============================================================================
# The problem
# =============================================================================
class ShardingProblem(TuningProblem):
    """Tune the train-step sharding layout of one model-zoo entry.

    ``backend="analytic"`` (the default) measures through the
    skewed/jittered analytic model; ``backend="compiled"`` counts the real
    train step per configuration through the dry run and prices its
    roofline (expensive: tens of seconds a test).
    """

    kind = "sharding"

    def __init__(self, arch, shape="train_4k", n_devices: int = 64,
                 backend: str = "analytic", noise: float = 0.01,
                 seed: int = 0):
        if isinstance(arch, str):
            from repro_torch.configs import ARCHS
            if arch not in ARCHS:
                raise KeyError(f"unknown model-zoo entry {arch!r}; "
                               f"available: {sorted(ARCHS)}")
            arch = ARCHS[arch]
        if isinstance(shape, str):
            if shape not in SHAPES:
                raise KeyError(f"unknown shape {shape!r}; available: "
                               f"{sorted(SHAPES)}")
            shape = SHAPES[shape]
        if backend not in ("analytic", "compiled"):
            raise ValueError(f"backend must be 'analytic' or 'compiled', "
                             f"got {backend!r}")
        self.arch: ArchConfig = arch
        self.shape: ShapeConfig = shape
        self.n_devices = int(n_devices)
        self.backend = backend
        self.noise = float(noise)
        self.seed = int(seed)
        self.name = f"{arch.name}/{shape.name}"
        self.bucket = f"{shape.name}-c{self.n_devices}"
        self._space: Optional[TuningSpace] = None

    @classmethod
    def from_name(cls, name: str, **params) -> "ShardingProblem":
        """``"<arch>/<shape>"`` (shape optional, default train_4k)."""
        arch, _, shape = name.partition("/")
        return cls(arch, shape or "train_4k", **params)

    def space(self) -> TuningSpace:
        if self._space is None:
            self._space = sharding_space(
                self.n_devices, name=f"sharding_{self.arch.name}")
        return self._space

    # -- the portable counter model -------------------------------------------
    def workload_fn(self) -> Callable[[Config], Dict[str, float]]:
        a, s = self.arch, self.shape
        chips = float(self.n_devices)
        P = arch_param_count(a)
        Pa = arch_active_param_count(a)
        tokens = float(s.seq_len) * float(s.global_batch)
        d_model, n_layers, seq_len = float(a.d_model), float(a.n_layers), \
            float(s.seq_len)
        d_ff = float(a.moe_d_ff or a.d_ff)

        def wl(cfg: Config) -> Dict[str, float]:
            d, m = parse_mesh(cfg["MESH"])
            fsdp, seq = bool(cfg["FSDP"]), bool(cfg["SEQ"])
            ga = float(cfg.get("GA", 1))
            tok_local = tokens / d
            act_shard = float(m) if seq else 1.0

            # compute: dense param flops + head-sharded attention flops.
            # The MLP shard pads to 256-lane granularity (the
            # warp-efficiency analog): counting the padded lanes as issued
            # matrix work keeps the counter a *learnable* per-config effective
            # quantity instead of a side-channel the TP→PC model never sees.
            f_shard = max(1.0, d_ff / m)
            lane_e = (f_shard / LANE_GRAN) / math.ceil(f_shard / LANE_GRAN)
            mxu = (6.0 * Pa * tokens / chips
                   + 12.0 * tok_local * seq_len * d_model * n_layers / m) \
                / lane_e

            # resident training state per chip; memory oversubscription vs
            # the reference capacity is the portable spill counter
            resident = P * STATE_BYTES_PER_PARAM \
                / (m * (d if fsdp else 1.0))
            # only one microbatch's activations are live at a time
            act_resident = n_layers * tok_local * d_model * BYTES * 4.0 \
                / (act_shard * ga)
            spill = 4.0 * max(0.0, resident + act_resident - REF_HBM_BYTES)

            # DRAM traffic: state read/update + activation fwd/bwd traffic
            # + the fp32 accumulator shard re-streamed per extra microbatch
            act_traffic = n_layers * tok_local * d_model * BYTES * 6.0 \
                / act_shard
            acc_traffic = (ga - 1.0) * P * 4.0 / (m * (d if fsdp else 1.0))
            hbm_rd = 2.0 * resident + 0.5 * act_traffic + acc_traffic
            hbm_wr = resident + 0.5 * act_traffic + acc_traffic

            # link: per-layer TP ring all-reduces + per-step grad/param sync
            tp_coll = 0.0 if m == 1 else \
                4.0 * n_layers * 2.0 * (m - 1.0) / m \
                * tok_local * d_model * BYTES
            dp_coll = 0.0 if d == 1 else \
                (3.0 if fsdp else 2.0) * (d - 1.0) / d * P * BYTES / m
            vpu = n_layers * tok_local * d_model * 20.0 / act_shard

            # per-program working set: activation tile + MLP weight shard
            ws = TILE_TOKENS * d_model * BYTES * 3.0 / (2.0 if seq else 1.0) \
                + d_model * (d_ff / m) * BYTES
            grid = n_layers * math.ceil(tok_local / ga / TILE_TOKENS) * ga
            return {
                C.FP32_FLOPS: float(mxu),
                C.INT_OPS: float(vpu),
                C.INST_ISSUED: float(mxu / 128.0 + vpu),
                C.DRAM_RD: float(hbm_rd),
                C.DRAM_WR: float(hbm_wr),
                C.SMEM_RD: float(2.0 * hbm_rd),
                C.SMEM_WR: float(2.0 * hbm_wr),
                C.LOCAL_B: float(spill),
                C.NVLINK_B: float(tp_coll + dp_coll),
                C.SMEM_WS: float(ws),
                C.CTAS: float(grid),
            }

        return wl

    # -- measurement substrates -----------------------------------------------
    def measured_runtime(self, cfg: Config, hw: HardwareSpec) -> float:
        """Deterministic 'ground truth' step time of one layout: the
        analytic model over hardware-skewed counters plus seeded jitter
        (the oracle ``bench_systems`` ranks predictions against)."""
        cs = self._measure(cfg, hw)
        return cs.runtime

    def _measure(self, cfg: Config, hw: HardwareSpec):
        wl = self.workload_fn()
        ops = wl(cfg)
        ops[C.DRAM_RD] = ops[C.DRAM_RD] * 1.12      # the model never sees
        ops[C.NVLINK_B] = ops[C.NVLINK_B] * 1.15    # these skews
        cs = costmodel.execute(ops, hw)
        d, m = parse_mesh(cfg["MESH"])
        rng = np.random.default_rng(
            [self.seed, d, m, int(cfg["FSDP"]), int(cfg["SEQ"]),
             int(cfg.get("GA", 1))])
        jitter = (2.0 * rng.random() - 1.0) * self.noise
        cs.runtime = cs.runtime * (1.0 + jitter) + 2e-3
        return cs

    def make_evaluator(self, hw: HardwareSpec) -> Optional[Callable]:
        if self.backend == "compiled":
            return self._compiled_evaluator(hw)
        from repro_torch.core.evaluate import (PROFILE_FIXED,
                                               PROFILE_SLOWDOWN,
                                               TEST_OVERHEAD)
        space = self.space()

        def fn(index: int, profile: bool):
            cs = self._measure(space[int(index)], hw)
            rt = float(cs.runtime)
            if profile:
                return rt, cs, rt * PROFILE_SLOWDOWN + TEST_OVERHEAD \
                    + PROFILE_FIXED
            return rt, None, rt + TEST_OVERHEAD

        return fn

    def _compiled_evaluator(self, hw: HardwareSpec) -> Callable:
        """Count the REAL train step per configuration (the dry run); price
        its roofline (flops / device-memory bytes / ring-scaled collective
        bytes) as counters.  The production mesh fixes the chip layout, so
        only the rules knobs (FSDP/SEQ/TP) vary here; mesh-shape pricing
        stays with the analytic backend."""
        from repro_torch.core.evaluate import (PROFILE_FIXED,
                                               PROFILE_SLOWDOWN,
                                               TEST_OVERHEAD)
        space = self.space()

        def fn(index: int, profile: bool):
            from repro_torch.launch.dryrun import lower_cell
            cfg = space[int(index)]
            _, m = parse_mesh(cfg["MESH"])
            rec = lower_cell(
                self.arch.name, self.shape.name, multi_pod=False,
                step_overrides={"microbatches": int(cfg.get("GA", 1))},
                rules_overrides={
                    "embed": "data" if cfg["FSDP"] else None,
                    "seq": "data" if cfg["SEQ"] else None,
                    **({} if m > 1 else
                       {k: None for k in
                        ("vocab", "heads", "kv", "mlp", "expert")}),
                },
                verbose=False)
            rf = rec["roofline"]
            rt = max(float(rf["compute_s"]), float(rf["memory_s"]),
                     float(rf["collective_s"]))
            chips = max(1.0, float(rf.get("chips", 1)))
            ops = {
                C.FP32_FLOPS: float(rf["flops"]) / chips,
                C.DRAM_RD: 0.6 * float(rf["hbm_bytes"]) / chips,
                C.DRAM_WR: 0.4 * float(rf["hbm_bytes"]) / chips,
                C.NVLINK_B: float(rf["collective_bytes"]),
                C.CTAS: float(self.arch.n_layers),
            }
            cs = costmodel.execute(ops, hw)
            cs.runtime = max(rt, 1e-9)
            if profile:
                return cs.runtime, cs, rt * PROFILE_SLOWDOWN \
                    + TEST_OVERHEAD + PROFILE_FIXED
            return cs.runtime, None, rt + TEST_OVERHEAD

        return fn
