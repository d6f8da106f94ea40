"""``ConfigStore`` — persistent tuned-config + model-artifact store.

The paper's motivation (ii): autotuning must be *repeated* whenever the
processed-data characteristics change, and a portable TP→PC model makes each
repetition cheap.  In a serving system that repetition happens online — the
request mix shifts, the engine retunes — so the results must outlive the
process: the second time a workload shape shows up (or the service restarts)
the tuned configuration is reused with ZERO live trials.

The store is one JSON file holding two artifact kinds under the same key
``(problem kind, space name, input-shape bucket, hardware)``:

* **entries** — tuned configurations (`config`, `runtime`, `trials`, free-form
  `meta`), written by the online tuner after live trials;
* **models**  — trained TP→PC_ops model artifacts in the
  ``repro_torch.tuning.serialize`` JSON format, so the warm-start ranking that
  keeps live-trial counts small is itself persistent and shippable across
  machines (``TuningSession.save_model_to_store``/``load_model_from_store``).
  Every stored artifact carries a monotonic ``revision`` (and optional
  ``n_obs``): merge conflicts between writers resolve to the higher
  revision, so a model retrained on newer data supersedes its stale
  ancestor instead of tying.  ``prune(keep_hardware=..., keep_spaces=...,
  keep_buckets=...)`` GCs artifacts for fleet members that no longer exist.

Model artifacts carry a structural **space signature**
(``repro_torch.tuning.signature``) so the warm-start ladder has a fifth,
cross-space tier: when no model of the exact space exists, the most
*structurally similar* same-kind space's model is rebound onto the new
space through the shared-counter intersection
(``nearest_transfer_key`` / ``load_transfer_model``).  A put signs an
artifact that arrives without a signature (``ensure_signature``).

Schema (``format: repro_torch.config_store``, version 3)::

    {
      "format": "repro_torch.config_store",
      "version": 3,
      "entries": {
        "kernel|conv2d|4096|h100_sxm": {
          "kind": "kernel", "space": "conv2d", "bucket": "4096",
          "hardware": "h100_sxm",
          "config": {"BY": 32, "BX": 128, ...},
          "runtime": 0.0123,          # best measured seconds
          "trials": 6,                # live empirical tests spent tuning it
          "meta": {...}               # free-form (e.g. ask-tell history)
        }, ...
      },
      "models": { "<same key>": <repro_torch.tppc_model artifact>, ... }
    }

The leading ``kind`` field namespaces keys by *problem kind* (the
``TuningProblem`` registry string: "kernel", "serve", "sharding", ...) so
artifacts from different problem kinds never collide even when their
space names do.  The format started at version 3: every key has four
parts and every model artifact its space signature, so the JAX package's
upgrade paths for 3-part keys and unsigned artifacts are not carried over,
and a file of another version is refused.  A caller that names no kind
gets the one ``legacy_kind`` infers from the space name.

This is the JAX package's store carried over line for line, under its own
format name: its model artifacts name the Hopper counters.

Writes are atomic (tempfile + ``os.replace``) and auto-saved when the store
is bound to a path; ``ConfigStore()`` with no path is a process-local cache
with the same API.

Concurrent writers are safe: ``save()`` takes an advisory file lock
(``<path>.lock``) and read-merge-writes — entries and models that other
processes persisted since our last load are merged in before the atomic
replace (conflicting tuned configs resolve to the better runtime), so a
fleet of tuner processes sharing one store never clobber each other.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

try:
    import fcntl
except ImportError:          # non-POSIX: degrade to atomic-replace only
    fcntl = None

from repro_torch.core.model import TPPCModel, TransferredModel
from repro_torch.core.tuning_space import Config, TuningSpace
from repro_torch.tuning.serialize import (artifact_signature, ensure_signature,
                                    model_from_dict, model_to_dict,
                                    rebind_model_dict)
from repro_torch.tuning.signature import (DEFAULT_TRANSFER_THRESHOLD,
                                    SpaceSignature, similarity,
                                    transfer_compatible)

FORMAT = "repro_torch.config_store"
VERSION = 3
# versions this code can read and merge: the format started at version 3
# (kind|space|bucket|hardware keys, signed model artifacts)
READABLE_VERSIONS = (3,)
_SEP = "|"
DEFAULT_KIND = "kernel"


def content_crc(entries: Dict[str, Any], models: Dict[str, Any]) -> int:
    """crc32 over the store's canonical content JSON.

    Saved as the top-level ``crc`` field; verified on load so a torn
    write or bit rot is detected instead of silently adopted.  Files
    written before checksumming (no ``crc`` field) still load.
    """
    return zlib.crc32(json.dumps(
        {"entries": entries, "models": models},
        separators=(",", ":"), sort_keys=True).encode("utf-8"))


def quarantine_file(path: str, why: str) -> str:
    """Move a damaged artifact aside as ``<path>.corrupt`` and log it.

    Never clobbers an earlier quarantine (numeric suffixes) and never
    raises — worst case the damaged file stays in place and the caller
    proceeds without it anyway.  Returns the destination (or ``path``
    itself when the move failed).
    """
    dest = path + ".corrupt"
    n = 1
    while os.path.exists(dest):
        dest = f"{path}.corrupt.{n}"
        n += 1
    try:
        os.replace(path, dest)
    except OSError:
        dest = path
    print(f"[store] quarantined {path} -> {dest}: {why}", file=sys.stderr)
    return dest


def legacy_kind(space: str) -> str:
    """Problem kind a space name implies when the caller names none: the
    serve autotuner's spaces (``serve_online`` / ``serve*``) are of kind
    ``serve``, everything else of kind ``kernel``."""
    return "serve" if str(space).startswith("serve") else DEFAULT_KIND


def store_key(space: str, bucket: str, hardware: str,
              kind: Optional[str] = None) -> str:
    """Canonical ``kind|space|bucket|hardware`` key (no field contains |).

    ``kind=None`` infers the problem kind from the space name via
    ``legacy_kind``."""
    parts = (str(kind if kind is not None else legacy_kind(space)),
             str(space), str(bucket), str(hardware))
    for p in parts:
        if _SEP in p:
            raise ValueError(f"store key field {p!r} contains {_SEP!r}")
    return _SEP.join(parts)


def split_key(key: str) -> Tuple[str, str, str, str]:
    """``(kind, space, bucket, hardware)`` of a 4-part store key."""
    parts = str(key).split(_SEP)
    if len(parts) == 4:
        return parts[0], parts[1], parts[2], parts[3]
    raise ValueError(f"malformed store key {key!r}: expected "
                     "kind|space|bucket|hardware")


class _FileLock:
    """Advisory exclusive lock for the store's read-merge-write section.

    POSIX ``flock`` on a sidecar ``<path>.lock`` file (never on the store
    file itself — the atomic ``os.replace`` would swap the locked inode out
    from under us).  Degrades to a no-op where ``fcntl`` is unavailable, in
    which case only single-writer atomicity is guaranteed.
    """

    def __init__(self, path: str):
        self.lock_path = path + ".lock"
        self._fd: Optional[int] = None

    def __enter__(self) -> "_FileLock":
        if fcntl is not None:
            self._fd = os.open(self.lock_path,
                               os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


@dataclasses.dataclass(frozen=True)
class StoreEntry:
    """One tuned configuration for one (kind, space, bucket, hardware)."""

    space: str
    bucket: str
    hardware: str
    config: Config
    runtime: float              # best measured seconds at tuning time
    trials: int                 # live empirical tests spent finding it
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kind: str = ""              # "" => inferred from the space name

    def __post_init__(self):
        if not self.kind:
            object.__setattr__(self, "kind", legacy_kind(self.space))

    @property
    def key(self) -> str:
        return store_key(self.space, self.bucket, self.hardware,
                         kind=self.kind)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "space": self.space, "bucket": self.bucket,
            "hardware": self.hardware, "config": dict(self.config),
            "runtime": float(self.runtime), "trials": int(self.trials),
            "meta": self.meta,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "StoreEntry":
        return StoreEntry(
            space=d["space"], bucket=d["bucket"], hardware=d["hardware"],
            config=dict(d["config"]), runtime=float(d["runtime"]),
            trials=int(d["trials"]), meta=dict(d.get("meta", {})),
            kind=str(d.get("kind", "")),
        )


class ConfigStore:
    """JSON-backed artifact store for tuned configs and TP→PC models.

    ``path=None`` keeps everything in memory (same API, nothing persisted);
    with a path, the file is loaded if it exists and every ``put`` /
    ``put_model`` re-saves atomically.
    """

    def __init__(self, path: Optional[str] = None, autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self._entries: Dict[str, StoreEntry] = {}
        self._models: Dict[str, Dict] = {}
        # (kind, space) -> sorted model keys: nearest_model_key and the
        # transfer tier scan one bucket instead of the whole corpus
        self._model_index: Dict[Tuple[str, str], List[str]] = {}
        # model key -> parsed SpaceSignature (or None when unsignable),
        # invalidated whenever the key mutates
        self._sig_cache: Dict[str, Optional[SpaceSignature]] = {}
        self.quarantined: List[str] = []   # damaged files moved aside
        # how the store's results were obtained, as its writer stamped it
        # (``set_provenance``); None: never stamped
        self.provenance: Optional[str] = None
        # delta-save bookkeeping: keys mutated since the last save to
        # self.path, and a stat token identifying our own last write
        self._dirty_entries: set = set()
        self._dirty_models: set = set()
        self._disk_token: Optional[Tuple[int, int, int]] = None
        self.save_stats: Dict[str, Any] = {
            "saves": 0,        # save() calls
            "noop": 0,         # clean saves skipped entirely
            "full": 0,         # full serialize-everything writes
            "delta": 0,        # dirty-key overlay writes
            "merged_reads": 0,  # saves that read+merged a changed file
            "last_s": 0.0, "total_s": 0.0,
        }
        if path is not None and os.path.exists(path):
            self.load(path)

    # -- tuned configs ---------------------------------------------------------
    def get(self, space: str, bucket: str, hardware: str,
            kind: Optional[str] = None) -> Optional[StoreEntry]:
        return self._entries.get(store_key(space, bucket, hardware,
                                           kind=kind))

    def put(self, space: str, bucket: str, hardware: str, config: Config,
            runtime: float, trials: int,
            meta: Optional[Dict[str, Any]] = None,
            kind: Optional[str] = None) -> StoreEntry:
        """Record a tuned config; the merge rule applies at put time.

        An existing entry with a strictly better (lower) runtime wins
        over the incoming one — the same resolution ``_merge_from``
        applies between files.  Resolving here keeps memory monotone,
        which the own-write save fast path depends on: it serializes
        memory without re-reading the file, so memory must never hold a
        worse value than anything already persisted."""
        entry = StoreEntry(space=space, bucket=bucket, hardware=hardware,
                           config=dict(config), runtime=float(runtime),
                           trials=int(trials), meta=dict(meta or {}),
                           kind=kind or "")
        prev = self._entries.get(entry.key)
        if prev is not None and prev.runtime < entry.runtime:
            return prev
        self._entries[entry.key] = entry
        self._dirty_entries.add(entry.key)
        self._autosave()
        return entry

    def entries(self) -> Iterator[StoreEntry]:
        return iter(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    # -- model index -----------------------------------------------------------
    # The model corpus is bucketed by (kind, space) and each bucket kept
    # sorted, so every warm-start lookup — and the cross-space transfer
    # scan — walks only the keys that can possibly match instead of
    # re-sorting and re-splitting the whole corpus per call.  ALL
    # ``self._models`` mutations must go through these helpers (or
    # ``_reindex_models`` after a bulk swap).
    def _index_add(self, key: str) -> None:
        kind, space, _, _ = split_key(key)
        keys = self._model_index.setdefault((kind, space), [])
        i = bisect.bisect_left(keys, key)
        if i >= len(keys) or keys[i] != key:
            keys.insert(i, key)
        self._sig_cache.pop(key, None)

    def _index_discard(self, key: str) -> None:
        kind, space, _, _ = split_key(key)
        keys = self._model_index.get((kind, space))
        if keys:
            i = bisect.bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                keys.pop(i)
            if not keys:
                del self._model_index[(kind, space)]
        self._sig_cache.pop(key, None)

    def _reindex_models(self) -> None:
        self._model_index = {}
        self._sig_cache = {}
        for k in sorted(self._models):
            kind, space, _, _ = split_key(k)
            self._model_index.setdefault((kind, space), []).append(k)

    def model_signature(self, key: str) -> Optional[SpaceSignature]:
        """Parsed structural signature of a stored artifact (cached), or
        None when the key is absent or the artifact has no recoverable
        structure."""
        if key not in self._models:
            return None
        if key in self._sig_cache:
            return self._sig_cache[key]
        sig = artifact_signature(self._models[key], kind=split_key(key)[0])
        self._sig_cache[key] = sig
        return sig

    # -- model artifacts -------------------------------------------------------
    def get_model_dict(self, space: str, bucket: str, hardware: str,
                       kind: Optional[str] = None) -> Optional[Dict]:
        return self._models.get(store_key(space, bucket, hardware,
                                          kind=kind))

    def model_keys(self) -> Iterator[str]:
        """All stored model-artifact keys (``kind|space|bucket|hardware``)."""
        return iter(self._models)

    def put_model_dict(self, space: str, bucket: str, hardware: str,
                       artifact: Dict,
                       revision: Optional[int] = None,
                       n_obs: Optional[int] = None,
                       kind: Optional[str] = None) -> None:
        """Store a model artifact under a MONOTONIC ``revision``.

        A model retrained on more observations must supersede its stale
        ancestor when two writers merge — runtime ties can't order
        artifacts, so every stored artifact carries ``revision``
        (defaults to ``existing revision + 1``, so retraining under the
        same key always moves forward) and optionally ``n_obs`` (how many
        observations trained it, informational).  ``_merge_from`` resolves
        model conflicts by the higher revision — and so does this method:
        a put with an explicitly LOWER revision than the artifact already
        in memory is a stale write and loses immediately, which keeps
        memory monotone for the own-write save fast path (memory is
        serialized without re-reading the file, so it must never hold a
        lower revision than anything already persisted).
        """
        key = store_key(space, bucket, hardware, kind=kind)
        artifact = ensure_signature(dict(artifact), kind=split_key(key)[0])
        prev = self._models.get(key)
        if revision is None:
            revision = int((prev or {}).get("revision", 0)) + 1
        artifact["revision"] = int(revision)
        if n_obs is not None:
            artifact["n_obs"] = int(n_obs)
        if prev is not None \
                and int(prev.get("revision", 0)) > artifact["revision"]:
            return
        self._models[key] = artifact
        self._index_add(key)
        self._dirty_models.add(key)
        self._autosave()

    def load_model(self, space: str, bucket: str, hardware: str,
                   bind_space: Optional[TuningSpace] = None,
                   kind: Optional[str] = None) -> Optional[TPPCModel]:
        """Reconstruct a stored model, optionally bound to an existing space
        (compatibility-checked by the serializer)."""
        d = self.get_model_dict(space, bucket, hardware, kind=kind)
        if d is None:
            return None
        return model_from_dict(d, space=bind_space)

    def save_model(self, space: str, bucket: str, hardware: str,
                   model: TPPCModel,
                   model_space: Optional[TuningSpace] = None,
                   revision: Optional[int] = None,
                   n_obs: Optional[int] = None,
                   kind: Optional[str] = None) -> None:
        self.put_model_dict(
            space, bucket, hardware,
            model_to_dict(model, model_space,
                          kind=kind if kind is not None
                          else legacy_kind(space)),
            revision=revision, n_obs=n_obs, kind=kind)

    def nearest_model_key(self, space: str, bucket: str, hardware: str,
                          kind: Optional[str] = None) -> Optional[str]:
        """Best stored-model key for ``(kind, space, bucket, hardware)``.

        Preference order mirrors the paper's portability claims: exact hit;
        same bucket on other hardware (PC_ops predictions are
        hardware-independent — §4.4's cross-GPU scenario); same hardware on
        another input bucket (§4.5's cross-input scenario); any model of the
        same space.  The scan never crosses problem kinds — a serve-space
        model must not warm-start a kernel job that happens to share the
        space name.  Ties break deterministically (sorted key order).
        ``None`` when no model of the kind+space exists.
        """
        kind = kind if kind is not None else legacy_kind(space)
        exact = store_key(space, bucket, hardware, kind=kind)
        if exact in self._models:
            return exact
        first_bucket = first_hw = first_space = None
        # one index bucket holds exactly the kind+space keys, pre-sorted,
        # so the legacy tie-break (first key in sorted order per tier)
        # is preserved without touching the rest of the corpus
        for k in self._model_index.get((kind, space), ()):
            _, _, b, h = split_key(k)
            if b == bucket:
                if first_bucket is None:
                    first_bucket = k
                    break                      # best possible tier: done
            elif h == hardware:
                if first_hw is None:
                    first_hw = k
            elif first_space is None:
                first_space = k
        for k in (first_bucket, first_hw, first_space):
            if k is not None:
                return k
        return None

    def transfer_candidates(self, signature: SpaceSignature,
                            bucket: str, hardware: str,
                            threshold: float = DEFAULT_TRANSFER_THRESHOLD
                            ) -> List[Tuple[str, float]]:
        """Every compatible-space model key, most preferred first.

        Scans same-kind index buckets for OTHER spaces (the four legacy
        tiers own the exact space), gates each artifact through
        ``transfer_compatible`` and ranks survivors by similarity — ties
        broken toward the same bucket, then the same hardware, then
        sorted key order.  One entry per (space, bucket, hardware) key;
        empty when nothing clears the threshold (transfer never engages
        on a weak match)."""
        found: List[Tuple[Tuple, str, float]] = []
        for (kk, s), keys in sorted(self._model_index.items()):
            if kk != signature.kind or s == signature.space:
                continue
            for k in keys:
                sig = self.model_signature(k)
                if sig is None \
                        or not transfer_compatible(sig, signature,
                                                   threshold=threshold):
                    continue
                sim = similarity(sig, signature)
                _, _, b, h = split_key(k)
                rank = (-sim, 0 if b == bucket else 1,
                        0 if h == hardware else 1, k)
                found.append((rank, k, sim))
        found.sort(key=lambda t: t[0])
        return [(k, sim) for _, k, sim in found]

    def nearest_transfer_key(self, signature: SpaceSignature,
                             bucket: str, hardware: str,
                             threshold: float = DEFAULT_TRANSFER_THRESHOLD
                             ) -> Optional[Tuple[str, float]]:
        """Fifth warm-start tier: best *compatible-space* model key, or
        ``None`` when nothing clears the threshold (see
        ``transfer_candidates`` for the full ranking)."""
        cands = self.transfer_candidates(signature, bucket, hardware,
                                         threshold=threshold)
        return cands[0] if cands else None

    def load_nearest_model(self, space: str, bucket: str, hardware: str,
                           bind_space: Optional[TuningSpace] = None,
                           kind: Optional[str] = None
                           ) -> Tuple[Optional[TPPCModel], Optional[str]]:
        """``(model, key)`` for the nearest stored artifact (None, None on
        miss) — the fleet's warm-start hook."""
        key = self.nearest_model_key(space, bucket, hardware, kind=kind)
        if key is None:
            return None, None
        return model_from_dict(self._models[key], space=bind_space), key

    def load_transfer_model(self, signature: SpaceSignature,
                            bucket: str, hardware: str,
                            bind_space: TuningSpace,
                            threshold: float = DEFAULT_TRANSFER_THRESHOLD
                            ) -> Tuple[Optional[TransferredModel],
                                       Optional[str], float]:
        """``(model, key, similarity)`` for the best compatible-space
        artifact, rebound onto ``bind_space`` through the shared-counter
        intersection — ``(None, None, 0.0)`` when no stored model clears
        the threshold.  Only consulted after all four exact-space tiers
        miss, so exact warm-start behavior is untouched."""
        found = self.nearest_transfer_key(signature, bucket, hardware,
                                          threshold=threshold)
        if found is None:
            return None, None, 0.0
        key, sim = found
        try:
            model = rebind_model_dict(self._models[key], bind_space,
                                      signature, source_key=key,
                                      similarity=sim)
        except (ValueError, KeyError, TypeError):
            # an artifact that gates as compatible but cannot rebind
            # (e.g. empty shared-counter set) is a miss, not a crash
            return None, None, 0.0
        return model, key, sim

    def load_transfer_ensemble(self, signature: SpaceSignature,
                               bucket: str, hardware: str,
                               bind_space: TuningSpace,
                               threshold: float
                               = DEFAULT_TRANSFER_THRESHOLD,
                               limit: Optional[int] = None
                               ) -> Tuple[Optional["TransferEnsemble"],
                                          Optional[str], float]:
        """``(ensemble, top_key, top_similarity)`` over EVERY
        compatible-space artifact, each rebound onto ``bind_space`` —
        ``(None, None, 0.0)`` when no stored model clears the threshold.

        The similarity-weighted committee beats the single most-similar
        source at the head of the ranking (where a warm start spends its
        trials): structure every compatible space agrees on is exactly
        what generalizes.  Candidates that gate as compatible but cannot
        rebind are skipped, not fatal.  ``limit`` caps the committee at
        the N most preferred sources (None: all)."""
        from repro_torch.core.model import TransferEnsemble

        members = []
        for key, sim in self.transfer_candidates(signature, bucket,
                                                 hardware,
                                                 threshold=threshold):
            try:
                members.append((rebind_model_dict(
                    self._models[key], bind_space, signature,
                    source_key=key, similarity=sim), sim))
            except (ValueError, KeyError, TypeError):
                continue
            if limit is not None and len(members) >= limit:
                break
        if not members:
            return None, None, 0.0
        return TransferEnsemble(members), members[0][0].source_key, \
            members[0][1]

    # -- persistence -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        entries = {k: e.to_dict() for k, e in sorted(self._entries.items())}
        models = {k: m for k, m in sorted(self._models.items())}
        return self._stamped({
            "format": FORMAT,
            "version": VERSION,
            "crc": content_crc(entries, models),
            "entries": entries,
            "models": models,
        })

    def _stamped(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if self.provenance is not None:
            payload["provenance"] = self.provenance
        return payload

    def set_provenance(self, provenance: str) -> None:
        """Stamp the store with how its results were obtained; written at
        once when the store is bound to a path.  A file of one provenance
        is never merged into a store of another (``_merge_from``)."""
        self.provenance = provenance
        if self.path is not None:
            self.save(force=True)

    def save(self, path: Optional[str] = None, merge: bool = True,
             _post_merge=None, force: bool = False) -> str:
        """Locked read-merge-write, then atomic replace — amortized.

        Under the file lock, entries/models persisted by OTHER writers since
        our last load are merged into memory first (``_merge_from``), so
        concurrent tuner processes sharing one store file never clobber each
        other's keys; ``merge=False`` restores plain last-writer-wins
        overwrite semantics (e.g. to intentionally reset a store).
        ``_post_merge`` (internal) runs after the merge and before the
        write — ``prune`` uses it to re-apply its filter so the on-disk
        copy of a pruned key is not immediately re-adopted.

        The store tracks which keys changed since the last save, which
        buys three hot-path shortcuts (``force=True`` disables all of
        them and always rewrites):

        * **clean no-op** — nothing dirty means the locked
          read-merge-write would only reproduce the file: skip it;
        * **own-write fast path** — when the file's stat token still
          matches our last write (single-writer case), skip the
          read-back + checksum + merge and just serialize memory;
        * **delta write** — when the file DID change under us, merge it
          in, then build the new payload by overlaying only the dirty
          keys onto the raw on-disk dicts, so unchanged entries/models
          skip re-serialization.
        """
        t0 = time.perf_counter()
        path = path if path is not None else self.path
        if path is None:
            raise ValueError("ConfigStore has no path; pass save(path=...)")
        same = path == self.path
        st = self.save_stats
        st["saves"] += 1
        dirty = bool(self._dirty_entries or self._dirty_models)
        if same and not dirty and not force and merge \
                and _post_merge is None and os.path.exists(path):
            # nothing of ours needs writing.  If the file still carries
            # our own last write, the whole call is a no-op; if another
            # writer changed it, refresh memory from disk (the merge
            # side effect callers rely on) but skip the rewrite — a
            # merge-respecting peer never holds worse values than ours.
            if self._disk_token is not None \
                    and self._stat_token(path) == self._disk_token:
                st["noop"] += 1
                return path
            with _FileLock(path):
                on_disk = self._read_checked(path)
                if on_disk is not None:
                    self._merge_from(on_disk)
                    st["merged_reads"] += 1
                self._disk_token = self._stat_token(path)
            st["noop"] += 1
            st["last_s"] = round(time.perf_counter() - t0, 9)
            st["total_s"] = round(st["total_s"] + st["last_s"], 9)
            return path
        with _FileLock(path):
            on_disk: Optional[Dict[str, Any]] = None
            if merge and os.path.exists(path):
                unchanged = (same and not force
                             and self._disk_token is not None
                             and self._stat_token(path) == self._disk_token)
                if not unchanged:
                    on_disk = self._read_checked(path)
                    if on_disk is not None:
                        self._merge_from(on_disk)
                        st["merged_reads"] += 1
            if _post_merge is not None:
                _post_merge()
            delta_ok = (same and not force and merge
                        and _post_merge is None
                        and on_disk is not None
                        and on_disk.get("version") == VERSION)
            if delta_ok:
                payload = self._delta_payload(on_disk)
                st["delta"] += 1
            else:
                payload = self.to_dict()
                st["full"] += 1
            self._write_atomic(path, payload)
            if same:
                self._dirty_entries.clear()
                self._dirty_models.clear()
                self._disk_token = self._stat_token(path)
            else:
                # a copy elsewhere must not launder dirtiness away from
                # self.path — and keys adopted from the foreign file
                # have to reach self.path on the next save too
                self._dirty_entries |= set(self._entries)
                self._dirty_models |= set(self._models)
        st["last_s"] = round(time.perf_counter() - t0, 9)
        st["total_s"] = round(st["total_s"] + st["last_s"], 9)
        return path

    @staticmethod
    def _stat_token(path: str) -> Optional[Tuple[int, int, int]]:
        """Identity of the file's current bytes.

        (inode, mtime_ns, size) alone is forgeable under rapid
        alternating writers: mkstemp recycles the just-freed inode, the
        kernel stamps mtime from the coarse (jiffy-granularity) clock,
        and two writers' payloads can match in size — so
        ``_write_atomic`` re-stamps every write with a true
        nanosecond-resolution mtime, which makes a token collision
        require two processes writing within the same nanosecond."""
        try:
            s = os.stat(path)
            return (s.st_ino, s.st_mtime_ns, s.st_size)
        except OSError:
            return None

    def _delta_payload(self, on_disk: Dict[str, Any]) -> Dict[str, Any]:
        """Merged payload from overlaying only the DIRTY keys onto the
        raw on-disk dicts (memory already holds the merged values, so a
        dirty key that lost its conflict writes back the disk value).
        A dirty key missing from memory (pruned, unsaved) is skipped —
        same outcome a full merging save would produce."""
        entries = dict(on_disk.get("entries", {}))
        models = dict(on_disk.get("models", {}))
        for k in self._dirty_entries:
            e = self._entries.get(k)
            if e is not None:
                entries[k] = e.to_dict()
        for k in self._dirty_models:
            m = self._models.get(k)
            if m is not None:
                models[k] = m
        entries = {k: entries[k] for k in sorted(entries)}
        models = {k: models[k] for k in sorted(models)}
        return self._stamped({"format": FORMAT, "version": VERSION,
                              "crc": content_crc(entries, models),
                              "entries": entries, "models": models})

    @staticmethod
    def _write_atomic(path: str, payload: Dict[str, Any]) -> None:
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".config_store.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            # the kernel's coarse clock can give back-to-back writes
            # identical mtimes; a true-ns stamp (after the close-flush,
            # which would re-stamp) keeps _stat_token honest (see its
            # docstring)
            t = time.time_ns()
            os.utime(tmp, ns=(t, t))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _merge_from(self, d: Dict[str, Any]) -> None:
        """Fold another store's dict into memory (the read-merge step).

        Unknown keys are adopted; a tuned-config conflict resolves to the
        better (lower) runtime — the fleet semantics: whoever found the
        faster configuration for a key wins.  A model conflict resolves to
        the HIGHER ``revision`` (a model retrained on more observations
        supersedes its stale ancestor; runtimes can't order artifacts);
        ties — including revision-less artifacts — keep ours.
        """
        if d.get("format") != FORMAT \
                or d.get("version") not in READABLE_VERSIONS:
            raise ValueError(
                f"refusing to merge non-{FORMAT}-v{READABLE_VERSIONS} file "
                f"(format={d.get('format')!r} version={d.get('version')!r})")
        theirs = d.get("provenance")
        if theirs != self.provenance:
            # results obtained one way never mix with another's; an empty
            # side has nothing to mix, and an empty store adopts the stamp
            if self.provenance is None and not self._entries \
                    and not self._models:
                self.provenance = theirs
            elif theirs is not None or d.get("entries") or d.get("models"):
                raise ValueError(
                    f"refusing to merge a store of {theirs or 'unstamped'} "
                    f"results into one of {self.provenance or 'unstamped'} "
                    "results")
        for k, e in d.get("entries", {}).items():
            other = StoreEntry.from_dict(e)
            mine = self._entries.get(k)
            if mine is None or other.runtime < mine.runtime:
                self._entries[k] = other
        for k, m in d.get("models", {}).items():
            mine = self._models.get(k)
            if mine is None or int(m.get("revision", 0)) \
                    > int(mine.get("revision", 0)):
                self._models[k] = m
                self._index_add(k)

    def prune(self, keep_hardware=None, keep_spaces=None,
              keep_buckets=None, keep_kinds=None,
              dry_run: bool = False) -> Dict[str, int]:
        """GC entries and model artifacts for retired fleet members.

        Each ``keep_*`` is an iterable of values to KEEP for that key
        field (``None``: no constraint on that field); anything failing
        any given constraint is dropped.  Returns a stats dict —
        ``{"dropped_entries", "kept_entries", "dropped_models",
        "kept_models", "dropped"}`` — so a daemon's periodic GC can be
        logged and tested; with ``dry_run=True`` nothing is mutated (or
        saved), only the stats are computed.  Autosaves when bound to a
        path and something was actually dropped.

            store.prune(keep_hardware={"h100_sxm"})  # h100_pcie left the fleet
            store.prune(keep_kinds={"kernel"})       # drop serve/sharding
            store.prune(keep_spaces={"gemm"}, dry_run=True)   # would-drop
        """
        keep_hardware = set(keep_hardware) if keep_hardware is not None \
            else None
        keep_spaces = set(keep_spaces) if keep_spaces is not None else None
        keep_buckets = set(keep_buckets) if keep_buckets is not None \
            else None
        keep_kinds = set(keep_kinds) if keep_kinds is not None else None

        def drop(key: str) -> bool:
            kk, s, b, h = split_key(key)
            return ((keep_kinds is not None and kk not in keep_kinds)
                    or (keep_spaces is not None and s not in keep_spaces)
                    or (keep_buckets is not None and b not in keep_buckets)
                    or (keep_hardware is not None and h not in keep_hardware))

        def apply() -> Dict[str, int]:
            doomed_e = [k for k in self._entries if drop(k)]
            doomed_m = [k for k in self._models if drop(k)]
            if not dry_run:
                for k in doomed_e:
                    del self._entries[k]
                for k in doomed_m:
                    del self._models[k]
                    self._index_discard(k)
            return {
                "dropped_entries": len(doomed_e),
                "kept_entries": len(self._entries) - (len(doomed_e)
                                                      if dry_run else 0),
                "dropped_models": len(doomed_m),
                "kept_models": len(self._models) - (len(doomed_m)
                                                    if dry_run else 0),
                "dropped": len(doomed_e) + len(doomed_m),
            }

        stats = apply()
        if stats["dropped"] and not dry_run and self.path is not None \
                and self.autosave:
            # the on-disk copy still holds the pruned keys; a plain merging
            # save would adopt them straight back, so re-apply the filter
            # after the merge, inside the lock
            self.save(_post_merge=apply)
        return stats

    def _read_checked(self, path: str) -> Optional[Dict[str, Any]]:
        """Parse + checksum-verify a store file; quarantine on damage.

        Truncated/invalid JSON and checksum mismatches — the artifacts a
        crashed writer or bad disk leaves behind — move the file aside
        as ``<path>.corrupt`` and return None so the caller continues
        with what it has, instead of taking the whole load path down.
        A VALID file of another format, version or key schema still
        raises: that is a caller pointing at the wrong file, not data
        damage.
        """
        try:
            with open(path) as f:
                d = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
            self.quarantined.append(
                quarantine_file(path, f"unreadable store file: {exc}"))
            return None
        if not isinstance(d, dict):
            self.quarantined.append(
                quarantine_file(path, "store file is not a JSON object"))
            return None
        if d.get("format") != FORMAT:
            raise ValueError(
                f"not a {FORMAT} artifact: format={d.get('format')!r}")
        if d.get("version") not in READABLE_VERSIONS:
            raise ValueError(
                f"unsupported {FORMAT} version {d.get('version')!r}")
        crc = d.get("crc")
        if crc is not None and crc != content_crc(d.get("entries", {}),
                                                  d.get("models", {})):
            self.quarantined.append(
                quarantine_file(path, "content checksum mismatch"))
            return None
        for k in list(d.get("entries", {})) + list(d.get("models", {})):
            split_key(k)       # a key of another schema is refused
        return d

    def load(self, path: str) -> "ConfigStore":
        """Load a store file; a damaged one is quarantined and the store
        comes up EMPTY (but usable) rather than crashing the caller."""
        d = self._read_checked(path)
        if path == self.path:
            self._dirty_entries.clear()
            self._dirty_models.clear()
            self._disk_token = None    # not set race-free; next save reads
        if d is None:
            self._entries, self._models = {}, {}
            self._reindex_models()
            return self
        self._entries = {k: StoreEntry.from_dict(e)
                         for k, e in d.get("entries", {}).items()}
        self._models = dict(d.get("models", {}))
        self.provenance = d.get("provenance")
        self._reindex_models()
        return self

    def _autosave(self) -> None:
        if self.path is not None and self.autosave:
            self.save()
