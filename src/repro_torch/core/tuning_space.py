"""Generic tuning spaces (paper §1, §3) — array-backed.

A *tuning parameter* (TP) takes one of a pre-defined set of discrete values.
The cross product of TPs, pruned by user constraints, forms the *tuning space*;
one element is a *tuning configuration*.  The searcher is agnostic to what the
parameters mean — they may tune CUDA block sizes, sharding layouts, remat
policies or anything else (the paper's central genericity claim).

The space is the unit the searcher re-scores at EVERY profiling step
(Algorithm 1 l.7), and paper benchmarks reach 205,216 configurations, so the
space materializes its numeric representation once at construction:

* ``feature_matrix`` — ``n_configs × n_params`` float64, the vectorized form
  every TP→PC model consumes (one row == ``vectorize(config)``);
* a hash index making ``index_of`` O(1) instead of a full scan;
* ``subspace_key_matrix`` / ``subspace_keys`` — per-config binary-subspace
  keys (§3.4.1), precomputed for the quadratic model's per-subspace matmuls.

``neighbours`` uses per-parameter-slot hashing (configs sharing all values
except one slot land in the same bucket), built lazily in O(n·p) — the old
per-query O(n²) full scan made Basin Hopping's local phase quadratic.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

Config = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TuningParameter:
    """One discrete tuning parameter."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has no values")
        object.__setattr__(self, "values", tuple(self.values))

    @property
    def is_binary(self) -> bool:
        """Binary TPs split the space into model subspaces (paper §3.4.1)."""
        try:
            return set(self.values) <= {0, 1, True, False}
        except TypeError:  # unhashable values (tuples-as-lists from JSON, ...)
            return False

    def encode(self, v: Any) -> float:
        """Numeric feature code of one value.

        Strings — and any other value ``float()`` cannot convert (tuples,
        enums, ...; the space is generic over what a parameter means) —
        encode as their declared index."""
        if isinstance(v, bool):
            return float(int(v))
        if isinstance(v, str):
            return float(self.values.index(v))
        try:
            return float(v)
        except (TypeError, ValueError):
            return float(self.values.index(v))


def _all_hashable(values: Sequence[Any]) -> bool:
    try:
        set(values)
        return True
    except TypeError:
        return False


def _encode_column(p: TuningParameter, cfgs: Sequence[Config]) -> List[float]:
    """Feature codes of one parameter across configs (dict fast path when
    the values are hashable, per-value ``encode`` otherwise)."""
    try:
        code = {v: p.encode(v) for v in p.values}
        # .encode fallback: configs from ANOTHER space may carry values
        # outside this parameter's declared list (cross-space prediction)
        return [
            code[v] if v in code else p.encode(v)
            for v in (c[p.name] for c in cfgs)
        ]
    except TypeError:  # unhashable values (e.g. JSON round-tripped tuples)
        return [p.encode(c[p.name]) for c in cfgs]


class TuningSpace:
    """Cross product of tuning parameters pruned by constraints.

    Constraints are predicates over a full configuration dict.  The space is
    materialized eagerly — configs as dicts (the searcher/evaluator API) and
    as a dense ``feature_matrix`` (the model/scoring API).
    """

    def __init__(
        self,
        parameters: Sequence[TuningParameter],
        constraints: Sequence[Callable[[Config], bool]] = (),
        name: str = "space",
    ):
        names = [p.name for p in parameters]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")
        self.name = name
        self.parameters: Tuple[TuningParameter, ...] = tuple(parameters)
        self.constraints = tuple(constraints)
        self._configs: List[Config] = [
            cfg
            for cfg in self._iter_cross_product()
            if all(c(cfg) for c in self.constraints)
        ]
        if not self._configs:
            raise ValueError(f"tuning space {name!r} is empty after constraints")
        # dense numeric form, one row per config (== vectorize(config))
        fm = np.empty((len(self._configs), len(self.parameters)),
                      dtype=np.float64)
        for j, p in enumerate(self.parameters):
            fm[:, j] = _encode_column(p, self._configs)
        fm.setflags(write=False)
        self._feature_matrix = fm
        # O(1) config -> index.  Keys are the RAW value tuples (exact
        # pre-hash-index equality semantics — feature encodings are not
        # injective when a parameter mixes strings and numerics); a
        # parameter whose values are unhashable (e.g. tuples deserialized
        # from JSON as lists) falls back to declared-index keys, which are
        # injective over its value list.
        self._hashable_values: Tuple[bool, ...] = tuple(
            _all_hashable(p.values) for p in self.parameters)
        self._index: Dict[Tuple[Any, ...], int] = {
            self._key_of(cfg): i for i, cfg in enumerate(self._configs)
        }
        # per-config binary-subspace keys (§3.4.1)
        bin_cols = [j for j, p in enumerate(self.parameters) if p.is_binary]
        skm = fm[:, bin_cols].astype(np.int64)
        skm.setflags(write=False)
        self._subspace_key_matrix = skm
        # slot-hash buckets for neighbours(); built lazily on first use
        self._slot_buckets: Optional[List[Dict[Tuple, List[int]]]] = None

    # -- basic container protocol ------------------------------------------------
    def _iter_cross_product(self) -> Iterator[Config]:
        names = [p.name for p in self.parameters]
        for combo in itertools.product(*(p.values for p in self.parameters)):
            yield dict(zip(names, combo))

    def __len__(self) -> int:
        return len(self._configs)

    def __getitem__(self, i: int) -> Config:
        return self._configs[i]

    def __iter__(self) -> Iterator[Config]:
        return iter(self._configs)

    @property
    def configs(self) -> List[Config]:
        return self._configs

    def _key_of(self, cfg: Config) -> Tuple[Any, ...]:
        """Hashable index key of a config: raw values, with declared-index
        fallback for parameters whose values are unhashable."""
        return tuple(
            cfg[p.name] if hashable else p.values.index(cfg[p.name])
            for p, hashable in zip(self.parameters, self._hashable_values)
        )

    def index_of(self, cfg: Config) -> int:
        if len(cfg) == len(self.parameters):
            try:
                i = self._index.get(self._key_of(cfg))
            except (KeyError, TypeError, ValueError):
                i = None  # missing parameter / unhashable / undeclared value
            # equality check: belt and braces for the declared-index
            # fallback path (an out-of-space value equal-comparing to a
            # declared one must not alias a different config)
            if i is not None and self._configs[i] == cfg:
                return i
        raise KeyError(f"config not in space: {cfg}")

    # -- structure queries used by the models (§3.4) ------------------------------
    @property
    def binary_parameters(self) -> List[TuningParameter]:
        return [p for p in self.parameters if p.is_binary]

    @property
    def nonbinary_parameters(self) -> List[TuningParameter]:
        return [p for p in self.parameters if not p.is_binary]

    @property
    def feature_matrix(self) -> np.ndarray:
        """``n_configs × n_params`` float64; row i == ``vectorize(self[i])``.

        Read-only: built once at construction and shared by every model.
        """
        return self._feature_matrix

    def vectorize(self, cfg: Config) -> List[float]:
        """Numeric feature vector in declared parameter order."""
        return [p.encode(cfg[p.name]) for p in self.parameters]

    def vectorize_configs(self, cfgs: Sequence[Config]) -> np.ndarray:
        """Batch ``vectorize``: ``len(cfgs) × n_params`` float64 matrix."""
        out = np.empty((len(cfgs), len(self.parameters)), dtype=np.float64)
        for j, p in enumerate(self.parameters):
            out[:, j] = _encode_column(p, cfgs)
        return out

    # -- neighbourhood structure (Basin Hopping §4.7, profile_local §3.9.1) -------
    def _buckets(self) -> List[Dict[Tuple, List[int]]]:
        if self._slot_buckets is None:
            n_slots = len(self.parameters)
            buckets: List[Dict[Tuple, List[int]]] = [
                {} for _ in range(n_slots)
            ]
            for i, cfg in enumerate(self._configs):
                key = self._key_of(cfg)
                for f in range(n_slots):
                    reduced = key[:f] + key[f + 1:]
                    buckets[f].setdefault(reduced, []).append(i)
            self._slot_buckets = buckets
        return self._slot_buckets

    def neighbours(self, idx: int) -> List[int]:
        """Indices of configs differing in exactly one parameter value.

        Used by the local phase of Basin Hopping (§4.7) — Kernel Tuner's
        greedy-ils neighbourhood.  Per-slot hashing: a neighbour differing
        only in slot f shares slot-f's reduced key with ``idx``, so each
        neighbour is found exactly once; total index build is O(n·p).
        """
        key = self._key_of(self._configs[idx])
        out: List[int] = []
        for f, bucket in enumerate(self._buckets()):
            out.extend(j for j in bucket[key[:f] + key[f + 1:]] if j != idx)
        out.sort()
        return out

    # -- binary-subspace structure (§3.4.1) ---------------------------------------
    @property
    def subspace_key_matrix(self) -> np.ndarray:
        """``n_configs × n_binary_params`` int64 key matrix (read-only)."""
        return self._subspace_key_matrix

    def subspace_key(self, cfg: Config) -> Tuple[Any, ...]:
        """Key identifying the binary-parameter subspace of cfg (§3.4.1)."""
        return tuple(int(bool(cfg[p.name])) for p in self.binary_parameters)

    def subspace_keys(self) -> List[Tuple[int, ...]]:
        """Per-config subspace keys, index-aligned with the space."""
        return [tuple(row) for row in self._subspace_key_matrix.tolist()]


def powers_of_two(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)
