"""Deterministic, resumable synthetic data pipeline: the JAX package's
``repro.data.pipeline`` carried over.

Every batch is a pure function of (seed, step), so a restored job at step
k regenerates exactly the batch it would have seen, and there is no
pipeline state to checkpoint.  ``make_batch`` is numpy only and gives the
JAX package's batch bit for bit; ``to_device`` places a host batch on a
device as tensors, and ``shard_batch`` places it on a mesh: each rank
copies only its own block of the global batch to its device and wraps it
as a ``DTensor`` of the global batch's shape.

The token stream mimics Zipf-distributed language tokens with
document-boundary structure and next-token labels (teacher forcing).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    frontend: str = ""            # "vision" | "audio" | ""
    frontend_len: int = 0
    frontend_dim: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for ``step``."""
    rng = _batch_rng(cfg, step)
    b, s = cfg.global_batch, cfg.seq_len
    # Zipf tokens clipped to vocab; 0 reserved as document separator
    toks = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
    toks = np.clip(toks, 1, cfg.vocab_size - 1).astype(np.int32)
    # document boundaries
    n_docs = max(1, s // cfg.mean_doc_len)
    for i in range(b):
        cuts = rng.integers(0, s + 1, size=n_docs)
        toks[i, cuts] = 0
    batch = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
    }
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def batch_iterator(cfg: DataConfig, start_step: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (contiguous copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], shardings) -> Dict:
    """Place a host batch onto the mesh with the given layouts
    (``repro_torch.distributed.sharding.batch_shardings``): each rank's
    block, on the mesh's device type (the rank's card, or the CPU)."""
    from repro_torch.distributed.sharding import local_slices

    out = {}
    for k, v in batch.items():
        lay = shardings[k]
        mesh = lay.mesh
        block = np.ascontiguousarray(v[local_slices(mesh, lay.spec,
                                                    v.shape)])
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        out[k] = DTensor.from_local(torch.from_numpy(block).to(dev), mesh,
                                    lay.placements, run_check=False)
    return out
