"""Structural space signatures — the key for cross-space model transfer.

The paper's portability claim (§4.4/§4.5) is that TP→PC models carry
across GPUs and inputs because performance counters, not runtimes, are
the learned target.  The sister data paper (arXiv 2102.05299) goes one
step further: counter features are shared across *kernels*, so a model
trained on one tuning space is a useful prior for a structurally similar
space it has never seen.  This module gives that notion of "structurally
similar" a concrete, serializable form:

* ``SpaceSignature`` — the problem kind, the space name, one hashed
  ``ParamSlot`` per tuning parameter (name hash + value-structure hash +
  the encoded value codes), and the set of counter names the space's
  workload emits.  Computable from parameter lists alone (no config
  enumeration), from a ``TuningSpace``, or from a ``TuningProblem``.
* ``similarity(sig_a, sig_b)`` — counter-set Jaccard × parameter-
  structure overlap, in [0, 1].
* ``transfer_compatible(sig_a, sig_b)`` — the gate the store's
  compatible-space tier applies: same problem kind, shared counters,
  similarity at or above a conservative threshold.

Parameter matching is the hashed-slot idiom (archai's ``transfer_utils``
applies it to hashed layer names when grafting weights between network
variants): each parameter hashes both its *name* and its *value
structure*, so a renamed parameter still pairs by structure hash, an
extended parameter (same name, more values) still pairs by name hash,
and the pair's score is the Jaccard of the encoded value sets — partial
credit for partial range overlap.  ``match_slots`` returns the pairing
itself, which is what model rebinding uses to route a target config's
values into the source model's feature columns.

Deliberately import-light (``repro_torch.core.tuning_space`` only): the
store and the serializer build on it without cycles.  This is the JAX
package's module carried over line for line; a port signature names the
Hopper counters of ``core/counters.py``.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tuning_space import TuningParameter, TuningSpace

SIG_FORMAT = "repro_torch.space_signature"
SIG_VERSION = 1

# Conservative default gate for the store's compatible-space tier: high
# enough that a sharded-layout or serve-geometry space does not
# masquerade as a kernel-tile prior on range overlap alone, low enough
# that sibling kernel spaces (shared counter sets, block-size-shaped
# parameters) pass.  Callers pin it per deployment through the store's
# ``threshold=`` arguments.
DEFAULT_TRANSFER_THRESHOLD = 0.35


def _crc_hex(obj: Any) -> str:
    """Stable 8-hex-digit content hash of a JSON-safe object."""
    blob = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    return f"{zlib.crc32(blob.encode('utf-8')):08x}"


def _param_codes(p: TuningParameter) -> Tuple[float, ...]:
    """Sorted unique feature codes of a parameter's declared values —
    the numeric shadow every model consumes (``TuningParameter.encode``),
    so two parameters with the same codes are interchangeable slots."""
    return tuple(sorted({float(p.encode(v)) for v in p.values}))


@dataclasses.dataclass(frozen=True)
class ParamSlot:
    """One tuning parameter's hashed structural identity.

    ``name_hash`` pairs renamed-compatible slots (same name, possibly
    extended values); ``struct_hash`` pairs renamed slots (same value
    structure under a different name); ``codes`` carries the encoded
    value set so a pair's score — and cross-space value snapping — can
    be computed without the original parameter object.
    """

    name_hash: str
    struct_hash: str
    is_binary: bool
    codes: Tuple[float, ...]

    @staticmethod
    def of(p: TuningParameter) -> "ParamSlot":
        codes = _param_codes(p)
        return ParamSlot(
            name_hash=_crc_hex(p.name),
            struct_hash=_crc_hex([bool(p.is_binary), list(codes)]),
            is_binary=bool(p.is_binary),
            codes=codes,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"name_hash": self.name_hash,
                "struct_hash": self.struct_hash,
                "is_binary": self.is_binary,
                "codes": list(self.codes)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ParamSlot":
        return ParamSlot(
            name_hash=str(d["name_hash"]),
            struct_hash=str(d["struct_hash"]),
            is_binary=bool(d["is_binary"]),
            codes=tuple(float(c) for c in d["codes"]),
        )


def _code_jaccard(a: ParamSlot, b: ParamSlot) -> float:
    """Value-set overlap of two slots: Jaccard over encoded codes, so an
    extended parameter scores the shared prefix rather than 0 or 1."""
    sa, sb = set(a.codes), set(b.codes)
    union = sa | sb
    if not union:
        return 1.0
    return len(sa & sb) / len(union)


def match_slots(a: Sequence[ParamSlot], b: Sequence[ParamSlot]
                ) -> List[Tuple[int, int, float]]:
    """Pair slots of two signatures: ``(index_in_a, index_in_b, score)``.

    Three passes, each consuming only still-unpaired slots, all ties
    broken in declared order (deterministic across processes):

    1. **name hash** — the common case (same parameter, possibly with an
       extended value list);
    2. **structure hash** — a renamed parameter with an identical value
       structure;
    3. **greedy value overlap** — renamed AND reshaped parameters pair
       by best code-set Jaccard, binary slots only with binary slots.

    The pair score is the code-set Jaccard in every pass.
    """
    pairs: List[Tuple[int, int, float]] = []
    used_a: set = set()
    used_b: set = set()
    by_name: Dict[str, int] = {}
    for j, sb in enumerate(b):
        by_name.setdefault(sb.name_hash, j)
    for i, sa in enumerate(a):
        j = by_name.get(sa.name_hash)
        if j is not None and j not in used_b:
            pairs.append((i, j, _code_jaccard(sa, b[j])))
            used_a.add(i)
            used_b.add(j)
    for i, sa in enumerate(a):
        if i in used_a:
            continue
        for j, sb in enumerate(b):
            if j in used_b or sb.struct_hash != sa.struct_hash:
                continue
            pairs.append((i, j, _code_jaccard(sa, sb)))
            used_a.add(i)
            used_b.add(j)
            break
    ranked: List[Tuple[float, int, int]] = []
    for i, sa in enumerate(a):
        if i in used_a:
            continue
        for j, sb in enumerate(b):
            if j in used_b or sb.is_binary != sa.is_binary:
                continue
            s = _code_jaccard(sa, sb)
            if s > 0.0:
                ranked.append((-s, i, j))
    for neg_s, i, j in sorted(ranked):
        if i in used_a or j in used_b:
            continue
        pairs.append((i, j, -neg_s))
        used_a.add(i)
        used_b.add(j)
    return pairs


@dataclasses.dataclass(frozen=True)
class SpaceSignature:
    """Structural identity of one tuning problem's space.

    ``kind`` is the ``TuningProblem`` registry string ("kernel",
    "serve", ...) — transfer NEVER crosses kinds; ``space`` the space
    name (informational: the store's compatible-space tier only consults
    it to exclude same-space artifacts the legacy tiers already cover);
    ``slots`` one ``ParamSlot`` per parameter in declared order;
    ``counters`` the sorted counter-name set the space's workload emits
    (for a stored model artifact: the counters the model predicts).
    """

    kind: str
    space: str
    slots: Tuple[ParamSlot, ...]
    counters: Tuple[str, ...]

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def from_parameters(parameters: Sequence[TuningParameter],
                        kind: str, space: str,
                        counters: Sequence[str] = ()) -> "SpaceSignature":
        """The core constructor: parameter (name, values) lists are all
        the structure needed — no config enumeration, so signing a
        200k-config space (or a serialized artifact's recorded
        parameters) costs O(params)."""
        return SpaceSignature(
            kind=str(kind), space=str(space),
            slots=tuple(ParamSlot.of(p) for p in parameters),
            counters=tuple(sorted(set(str(c) for c in counters))),
        )

    @staticmethod
    def from_space(space: TuningSpace, kind: str,
                   counters: Sequence[str] = ()) -> "SpaceSignature":
        return SpaceSignature.from_parameters(
            space.parameters, kind=kind, space=space.name,
            counters=counters)

    @staticmethod
    def from_problem(problem) -> "SpaceSignature":
        """Sign any ``TuningProblem``: counter names are sampled from one
        workload evaluation (the portable ``g(TP) → PC`` model is pure
        and cheap — no hardware touched)."""
        space = problem.space()
        counters: Sequence[str] = ()
        try:
            counters = sorted(problem.workload_fn()(space[0]))
        except Exception:
            pass   # a problem without a workable counter model still signs
        return SpaceSignature.from_space(space, kind=problem.kind,
                                         counters=counters)

    # -- identity / persistence -------------------------------------------------
    @property
    def sig_hash(self) -> str:
        """Content hash of the whole signature (stats/log identity)."""
        return _crc_hex(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format": SIG_FORMAT,
            "version": SIG_VERSION,
            "kind": self.kind,
            "space": self.space,
            "slots": [s.to_dict() for s in self.slots],
            "counters": list(self.counters),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SpaceSignature":
        if d.get("format") != SIG_FORMAT:
            raise ValueError(
                f"not a {SIG_FORMAT} dict: format={d.get('format')!r}")
        if d.get("version") != SIG_VERSION:
            raise ValueError(
                f"unsupported {SIG_FORMAT} version {d.get('version')!r}")
        return SpaceSignature(
            kind=str(d.get("kind", "")),
            space=str(d.get("space", "")),
            slots=tuple(ParamSlot.from_dict(s) for s in d.get("slots", [])),
            counters=tuple(str(c) for c in d.get("counters", [])),
        )


def counter_jaccard(sig_a: SpaceSignature, sig_b: SpaceSignature) -> float:
    """Jaccard over the counter-name sets (1.0 when both are empty —
    two spaces that name no counters are vacuously counter-compatible)."""
    ca, cb = set(sig_a.counters), set(sig_b.counters)
    union = ca | cb
    if not union:
        return 1.0
    return len(ca & cb) / len(union)


def parameter_overlap(sig_a: SpaceSignature, sig_b: SpaceSignature) -> float:
    """Matched-slot score mass over the larger parameter count, in
    [0, 1]: 1.0 only when every parameter of the larger space pairs with
    an identical-valued slot of the other."""
    na, nb = len(sig_a.slots), len(sig_b.slots)
    if na == 0 and nb == 0:
        return 1.0
    if na == 0 or nb == 0:
        return 0.0
    pairs = match_slots(sig_a.slots, sig_b.slots)
    return sum(s for _, _, s in pairs) / max(na, nb)


def similarity(sig_a: SpaceSignature, sig_b: SpaceSignature) -> float:
    """Counter-set Jaccard × parameter-structure overlap — the transfer
    metric the store's compatible-space tier ranks candidates by."""
    return counter_jaccard(sig_a, sig_b) * parameter_overlap(sig_a, sig_b)


def transfer_compatible(sig_a: SpaceSignature, sig_b: SpaceSignature,
                        threshold: float = DEFAULT_TRANSFER_THRESHOLD
                        ) -> bool:
    """Whether a model signed ``sig_a`` may warm-start a job signed
    ``sig_b`` (symmetric): SAME problem kind — a serve-geometry model
    must never prior a kernel job however similar the ranges look — at
    least one shared counter to predict through (unless neither side
    names any), and similarity at or above the threshold."""
    if sig_a.kind != sig_b.kind:
        return False
    if (sig_a.counters or sig_b.counters) \
            and not (set(sig_a.counters) & set(sig_b.counters)):
        return False
    return similarity(sig_a, sig_b) >= float(threshold)


def map_parameters(source: SpaceSignature, target: SpaceSignature
                   ) -> Dict[int, int]:
    """Source-slot index → target-slot index for model rebinding: the
    hashed-slot pairing of ``match_slots``, zero-score pairs dropped
    (nothing sensible to route through a fully disjoint value set)."""
    return {i: j for i, j, s in match_slots(source.slots, target.slots)
            if s > 0.0}
