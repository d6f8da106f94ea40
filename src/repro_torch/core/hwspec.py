"""NVIDIA Hopper hardware specifications (paper §4.2, Table 3).

Sources:

* [DS] NVIDIA H100 Tensor Core GPU data sheet: SM count, fp32 rate outside
  the tensor cores, dense TF32 tensor-core rate (the data sheet's
  "with sparsity" figures halved: 989 / 2 SXM, 756 / 2 PCIe), memory size
  and bandwidth, L2, NVLink, power.
* [WP] NVIDIA H100 Tensor Core GPU Architecture white paper (Hopper): per-SM
  function units (128 fp32 lanes, 64 int32 lanes, 16 SFU lanes), 128 bytes
  per clock of shared-memory bandwidth per SM, 227 KB of shared memory a
  block can use, boost clocks (1,980 MHz SXM, 1,755 MHz PCIe).
* [PG] CUDA C++ Programming Guide: the constant cache serves one 32-bit
  word per clock per SM (a warp's request is broadcast when all lanes read
  the same address).

A rate marked "derived" is units per clock per SM × SMs × boost clock.
``launch_latency`` is a modelling constant of the cost model (per-block
dispatch and first-load latency), not a data-sheet figure; the card
evaluator measures runtimes and never uses it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    generation: str
    fp32_flops: float      # FLOP/s, fp32 outside the tensor cores (FMA = 2)
    int_ops: float         # op/s, int32 lanes
    sfu_ops: float         # op/s, special-function lanes
    dram_bw: float         # bytes/s device memory
    smem_bw: float         # bytes/s shared memory, all SMs
    const_bw: float        # bytes/s constant cache, all SMs
    dram_bytes: float      # device memory capacity
    smem_bytes: float      # shared memory one block can use
    sms: int               # streaming multiprocessors
    nvlink_bw: float       # bytes/s per link, one direction
    nvlink_links: int      # links per card
    net_bw: float          # bytes/s off the node, per card
    launch_latency: float = 1.0e-6
    l2_bytes: Optional[float] = None   # not used by the cost model
    power_w: Optional[float] = None    # board power at full limit
    # FLOP/s, dense TF32 on the tensor cores (not used by the cost model)
    tf32_flops: Optional[float] = None

    @property
    def nvlink_card_bw(self) -> float:
        """Aggregate NVLink bandwidth per card, one direction."""
        return self.nvlink_bw * self.nvlink_links


_SXM_CLOCK = 1.98e9    # [WP] boost clock, H100 SXM5
_PCIE_CLOCK = 1.755e9  # [WP] boost clock, H100 PCIe

H100_SXM = HardwareSpec(
    name="h100_sxm", generation="hopper",
    fp32_flops=67e12,                        # [DS]
    int_ops=64 * 132 * _SXM_CLOCK,           # derived [WP]
    sfu_ops=16 * 132 * _SXM_CLOCK,           # derived [WP]
    dram_bw=3.35e12,                         # [DS] HBM3
    smem_bw=128 * 132 * _SXM_CLOCK,          # derived [WP]
    const_bw=4 * 132 * _SXM_CLOCK,           # derived [PG]
    dram_bytes=80e9,                         # [DS]
    smem_bytes=232_448,                      # [WP] 227 KB per block
    sms=132,                                 # [DS]
    nvlink_bw=25e9, nvlink_links=18,         # [DS] 900 GB/s both ways
    net_bw=50e9,                             # assumed: one 400 Gb/s NIC
    launch_latency=1.0e-6,
    l2_bytes=50e6,                           # [DS]
    power_w=700.0,                           # [DS]
    tf32_flops=495e12,                       # [DS] dense
)
H100_PCIE = HardwareSpec(
    name="h100_pcie", generation="hopper",
    fp32_flops=51e12,                        # [DS]
    int_ops=64 * 114 * _PCIE_CLOCK,          # derived [WP]
    sfu_ops=16 * 114 * _PCIE_CLOCK,          # derived [WP]
    dram_bw=2.0e12,                          # [DS] HBM2e
    smem_bw=128 * 114 * _PCIE_CLOCK,         # derived [WP]
    const_bw=4 * 114 * _PCIE_CLOCK,          # derived [PG]
    dram_bytes=80e9,                         # [DS]
    smem_bytes=232_448,                      # [WP]
    sms=114,                                 # [DS]
    nvlink_bw=25e9, nvlink_links=12,         # [DS] 600 GB/s bridge
    net_bw=50e9,                             # assumed: one 400 Gb/s NIC
    launch_latency=1.0e-6,
    l2_bytes=50e6,                           # [DS]
    power_w=350.0,                           # [DS]
    tf32_flops=378e12,                       # [DS] dense
)

SPECS: Dict[str, HardwareSpec] = {s.name: s for s in (H100_SXM, H100_PCIE)}


def spec_for_device_name(device_name: str) -> HardwareSpec:
    """The spec of a card named as ``torch.cuda.get_device_name`` names it.

    An unknown card raises: a guessed spec would mis-price every
    configuration and mis-analyse every bottleneck without telling anyone.
    """
    s = device_name.upper()
    if "H100" in s and "PCIE" in s:
        return H100_PCIE
    if "H100" in s and ("SXM" in s or "HBM3" in s):
        return H100_SXM
    raise RuntimeError(
        f"no hardware spec for card {device_name!r}; known: {sorted(SPECS)}")


def detect(index: int = 0) -> HardwareSpec:
    """The spec of CUDA card ``index``; raises without CUDA or for an
    unknown card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("hwspec.detect() needs a CUDA card; none is "
                           "visible")
    return spec_for_device_name(torch.cuda.get_device_name(index))
