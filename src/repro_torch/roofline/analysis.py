"""Three-term roofline of a dry-run count, at the H100's rates.

    compute    = Σ_unit flops_unit / rate_unit          (one device)
    memory     = bytes / DRAM bandwidth                 (one device)
    collective = Σ per-device collective bytes × ring factor / link rate

The JAX package's ``repro.roofline.analysis`` carried over: the same
``Roofline`` record and ``summary()`` keys, the same ring factors (an
all-gather or reduce-scatter moves (n-1)/n of its bytes a device, taken
as 1; an all-reduce twice that; an all-to-all 1), ``model_flops_train``
and ``model_flops_decode``.  The counts come from
``repro_torch.roofline.op_count`` (rank 0's ops of the step run on fake
tensors), not from HLO, and the rates from ``core.hwspec.H100_SXM``
instead of the JAX package's TPU constants:

* bf16 and fp16 products at the dense BF16 tensor-core rate
  (``bf16_flops``), fp32 products and elementwise work at ``fp32_flops``
  (the fp32 lanes), the attention kernel's products at ``tf32_flops / 3``
  (each is three TF32 products, 3xTF32);
* bytes at ``dram_bw``;
* a collective at NVLink's rate a card (``nvlink_card_bw``) where its
  group lies within one node of 8 cards, at ``net_bw`` where it crosses
  nodes.  On the production meshes every axis crosses nodes: the 16×16
  mesh's "model" axis joins 16 consecutive ranks (two nodes of 8) and its
  "data" axis ranks 16 apart (16 nodes); the 2×16×16 mesh adds "pod",
  ranks 256 apart.  Only meshes whose axes fit in 8 ranks (the tests' 2×2)
  price collectives at NVLink's rate.

Each unit's time is added, not overlapped: eager PyTorch runs one op at a
time.  ``flops`` and ``hbm_bytes`` are the whole program's (one device's
count × chips), as in the JAX record; ``xla_reported_flops`` holds one
device's products alone (bf16, fp32 and the kernel's), the count
PyTorch's own ``FlopCounterMode`` formulas give, kept as the JAX record
keeps XLA's ``cost_analysis`` beside its parse.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.hwspec import H100_SXM, HardwareSpec
from repro_torch.roofline.op_count import OpCount

_RING_FACTOR = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


@dataclasses.dataclass
class Roofline:
    flops: float               # whole program, all devices
    hbm_bytes: float           # whole program, all devices
    collective_bytes: float    # one device's, ring-scaled
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    collectives: CollectiveStats
    model_flops: float = 0.0   # 6·N·D (or 6·N_active·D) useful flops
    xla_reported_flops: float = 0.0  # one device's products alone

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def summary(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "xla_reported_flops": self.xla_reported_flops,
            "collective_by_op": self.collectives.bytes_by_op,
            "collective_counts": self.collectives.count_by_op,
        }


def compute_seconds(flops: Dict[str, float], hw: HardwareSpec) -> float:
    """One device's flops by unit at that unit's rate, added."""
    rates = {"bf16": hw.bf16_flops, "fp32": hw.fp32_flops,
             "tf32x3": hw.tf32_flops / 3.0}
    return sum(f / rates[unit] for unit, f in flops.items() if f)


def collective_seconds(links: Dict[str, Dict[str, float]],
                       hw: HardwareSpec) -> float:
    """One device's ring-scaled collective bytes at each link's rate."""
    rates = {"nvlink": hw.nvlink_card_bw, "net": hw.net_bw}
    return sum(b * _RING_FACTOR.get(op, 1.0) / rates[link]
               for link, by_op in links.items() for op, b in by_op.items())


def analyze_count(count: OpCount, chips: int, model_flops: float = 0.0,
                  hw: HardwareSpec = H100_SXM) -> Roofline:
    """Roofline of one device's ``OpCount`` on a mesh of ``chips``."""
    coll = CollectiveStats(bytes_by_op=dict(count.collective_bytes),
                           count_by_op=dict(count.collective_counts))
    per_chip_coll = sum(b * _RING_FACTOR.get(op, 1.0)
                        for op, b in coll.bytes_by_op.items())
    flops = count.total_flops
    return Roofline(
        flops=flops * chips,
        hbm_bytes=count.bytes * chips,
        collective_bytes=per_chip_coll,
        chips=chips,
        compute_s=compute_seconds(count.flops, hw),
        memory_s=count.bytes / hw.dram_bw,
        collective_s=collective_seconds(count.collective_links, hw),
        collectives=coll,
        model_flops=model_flops,
        xla_reported_flops=count.product_flops,
    )


def site_summary(count: OpCount, hw: HardwareSpec = H100_SXM) -> Dict:
    """A count's collective seconds and bytes and its peak's live bytes by
    call site (an ``OpCounter(sites=True)`` count), largest first."""
    secs = {site: collective_seconds(links, hw)
            for site, links in count.collective_sites.items()}
    return {
        "collective_s": dict(sorted(secs.items(), key=lambda kv: -kv[1])),
        "collective_bytes": {
            site: sum(b for by_op in count.collective_sites[site].values()
                      for b in by_op.values())
            for site in sorted(secs, key=lambda k: -secs[k])},
        "peak_bytes": dict(sorted(count.peak_sites.items(),
                                  key=lambda kv: -kv[1])),
    }


def model_flops_train(n_params_active: int, tokens: int) -> float:
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: int, tokens: int) -> float:
    return 2.0 * n_params_active * tokens
