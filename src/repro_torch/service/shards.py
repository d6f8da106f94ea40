"""``ShardedConfigStore`` — one tuned-config corpus, hash-partitioned.

A single JSON store file is fine for one fleet process, but the service
multiplexes many tenants and may run next to other daemons sharing the
same corpus: every ``save()`` is a locked read-merge-write of the WHOLE
file, so unrelated keys contend on one lock and every publish re-parses
every artifact.  Sharding fixes both: keys are partitioned by
``crc32(key) % n_shards`` across ``n_shards`` ordinary ``ConfigStore``
files in one directory, so writers touching different shards never
contend and a publish only rewrites the (small) shard it lands in.

Layout::

    <root>/
      shards.json      # {"format": "repro_torch.sharded_store", ...}
      shard-00.json    # plain repro_torch.config_store files, each
      shard-01.json    #   merge-safe (file lock + read-merge-write), so
      ...              #   concurrent daemons resolve conflicts per shard

``crc32`` (not Python's ``hash``) keeps the partition deterministic
across processes regardless of ``PYTHONHASHSEED`` — two daemons MUST
route the same key to the same shard file or merge safety is lost.  The
shard count is fixed at corpus creation and recorded in ``shards.json``
(written under a file lock so concurrent first-creators agree); later
openers adopt the recorded count, ignoring a conflicting request.

The facade mirrors the ``ConfigStore`` API (including the settable
``autosave`` used by ``FleetTuner``'s publish batching), tracking dirty
shards so ``save()`` only rewrites the files actually touched.

This is the JAX package's sharded corpus on the port's ``ConfigStore``,
under its own metafile format: a corpus whose ``shards.json`` names
another format (the JAX package's ``repro.sharded_store``) is refused, as
the port's store refuses a JAX store file.  The port's store holds 4-part
keys only, so no key is ever re-homed after an upgrade, and the JAX
corpus's rebalancing pass is not carried over.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.model import TPPCModel, TransferredModel
from repro_torch.core.tuning_space import Config, TuningSpace
from repro_torch.tuning.serialize import rebind_model_dict
from repro_torch.tuning.signature import (DEFAULT_TRANSFER_THRESHOLD,
                                    SpaceSignature, similarity,
                                    transfer_compatible)
from repro_torch.tuning.store import (ConfigStore, StoreEntry, _FileLock,
                                quarantine_file, split_key, store_key)

META_FORMAT = "repro_torch.sharded_store"
META_VERSION = 1
META_FILE = "shards.json"
DEFAULT_SHARDS = 4


def shard_of(key: str, n_shards: int) -> int:
    """Deterministic cross-process shard index for a store key."""
    return zlib.crc32(key.encode("utf-8")) % n_shards


class ShardedConfigStore:
    """``ConfigStore``-compatible facade over ``n_shards`` store files.

    Point it at a directory; the shard files and metafile are created on
    first use.  ``autosave=True`` (default) persists the touched shard on
    every mutation, exactly like a path-bound ``ConfigStore``; setting
    ``autosave = False`` batches mutations until ``save()``, which
    flushes only dirty shards (each through the underlying store's
    locked read-merge-write, so other processes' writes merge in).
    """

    def __init__(self, root: str, n_shards: int = DEFAULT_SHARDS,
                 autosave: bool = True):
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        self.root = root
        os.makedirs(root, exist_ok=True)
        # how the corpus's results were obtained, as ``shards.json``
        # records it (``set_provenance``); None: never stamped
        self.provenance: Optional[str] = None
        self.n_shards = self._bind_meta(n_shards)
        self._autosave = autosave
        self._shards: List[ConfigStore] = []
        self._dirty: set = set()
        for i in range(self.n_shards):
            # the facade owns persistence: shards never autosave themselves
            self._shards.append(
                ConfigStore(path=self._shard_path(i), autosave=False))

    # -- wiring ----------------------------------------------------------------
    @property
    def path(self) -> str:
        """The corpus root directory (non-None: 'persistent' to callers)."""
        return self.root

    @property
    def quarantined(self) -> List[str]:
        """Damaged files moved aside across all shards (load/merge time).

        A quarantined shard comes up empty instead of crashing the load
        path; its keys are then rebuilt from peers' merges and/or the
        daemon's journal replay (``TuningDaemon`` re-puts journaled
        results that are missing from the store on ``--recover``)."""
        return [p for s in self._shards for p in s.quarantined]

    @property
    def autosave(self) -> bool:
        return self._autosave

    @autosave.setter
    def autosave(self, value: bool) -> None:
        self._autosave = bool(value)

    def _shard_path(self, i: int) -> str:
        return os.path.join(self.root, f"shard-{i:02d}.json")

    def _meta_path(self) -> str:
        return os.path.join(self.root, META_FILE)

    def _bind_meta(self, requested: int) -> int:
        """Create-or-adopt the corpus shard count, atomically.

        The metafile is the one piece of state every writer must agree
        on — a daemon partitioning by a different count would scatter a
        key across files and break per-shard merge safety.  First
        creator wins under the file lock; everyone else adopts.
        """
        meta = self._meta_path()
        with _FileLock(meta):
            if os.path.exists(meta):
                d = None
                try:
                    with open(meta) as f:
                        d = json.load(f)
                except (json.JSONDecodeError, UnicodeDecodeError, OSError):
                    d = None
                if isinstance(d, dict) and d.get("format") == META_FORMAT \
                        and isinstance(d.get("shards"), int):
                    self.provenance = d.get("provenance")
                    return int(d["shards"])
                if isinstance(d, dict) \
                        and d.get("format") not in (None, META_FORMAT):
                    # a valid file of some OTHER format: caller error,
                    # not data damage — refuse loudly
                    raise ValueError(f"{meta} is not a {META_FORMAT} file")
                # torn/truncated metafile: quarantine it and re-derive
                # the count from the shard files already on disk.  Only
                # TOUCHED shards materialize, so the highest index is a
                # floor, not the count — the requested count fills in
                # (reopening with the same config is the common case).
                quarantine_file(meta, "unreadable shard metafile")
                highest = -1
                for f in os.listdir(self.root):
                    if f.startswith("shard-") and f.endswith(".json"):
                        try:
                            highest = max(highest, int(f[6:-5]))
                        except ValueError:
                            pass
                n = max(int(requested), highest + 1)
            else:
                n = int(requested)
            tmp = meta + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"format": META_FORMAT, "version": META_VERSION,
                           "shards": n}, f, indent=1)
            os.replace(tmp, meta)
            return n

    def set_provenance(self, provenance: str) -> None:
        """Stamp the corpus, in ``shards.json``, with how its results were
        obtained; a corpus another writer stamped otherwise is refused."""
        meta = self._meta_path()
        with _FileLock(meta):
            with open(meta) as f:
                d = json.load(f)
            if d.get("provenance") not in (None, provenance):
                raise ValueError(f"{self.root} holds {d['provenance']} "
                                 f"results, not {provenance} ones")
            d["provenance"] = provenance
            tmp = meta + ".tmp"
            with open(tmp, "w") as f:
                json.dump(d, f, indent=1)
            os.replace(tmp, meta)
        self.provenance = provenance

    def _shard(self, key: str) -> Tuple[ConfigStore, int]:
        i = shard_of(key, self.n_shards)
        return self._shards[i], i

    def _touched(self, i: int) -> None:
        if self._autosave:
            self._shards[i].save()
        else:
            self._dirty.add(i)

    # -- tuned configs ---------------------------------------------------------
    def get(self, space: str, bucket: str, hardware: str,
            kind: Optional[str] = None) -> Optional[StoreEntry]:
        shard, _ = self._shard(store_key(space, bucket, hardware, kind=kind))
        return shard.get(space, bucket, hardware, kind=kind)

    def put(self, space: str, bucket: str, hardware: str, config: Config,
            runtime: float, trials: int,
            meta: Optional[Dict[str, Any]] = None,
            kind: Optional[str] = None) -> StoreEntry:
        shard, i = self._shard(store_key(space, bucket, hardware, kind=kind))
        entry = shard.put(space, bucket, hardware, config, runtime,
                          trials, meta, kind=kind)
        self._touched(i)
        return entry

    def entries(self) -> Iterator[StoreEntry]:
        for shard in self._shards:
            yield from shard.entries()

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def __contains__(self, key: str) -> bool:
        shard, _ = self._shard(key)
        return key in shard

    # -- model artifacts -------------------------------------------------------
    def get_model_dict(self, space: str, bucket: str, hardware: str,
                       kind: Optional[str] = None) -> Optional[Dict]:
        shard, _ = self._shard(store_key(space, bucket, hardware, kind=kind))
        return shard.get_model_dict(space, bucket, hardware, kind=kind)

    def model_keys(self) -> Iterator[str]:
        for shard in self._shards:
            yield from shard.model_keys()

    def put_model_dict(self, space: str, bucket: str, hardware: str,
                       artifact: Dict, revision: Optional[int] = None,
                       n_obs: Optional[int] = None,
                       kind: Optional[str] = None) -> None:
        shard, i = self._shard(store_key(space, bucket, hardware, kind=kind))
        shard.put_model_dict(space, bucket, hardware, artifact,
                             revision=revision, n_obs=n_obs, kind=kind)
        self._touched(i)

    def load_model(self, space: str, bucket: str, hardware: str,
                   bind_space: Optional[TuningSpace] = None,
                   kind: Optional[str] = None) -> Optional[TPPCModel]:
        shard, _ = self._shard(store_key(space, bucket, hardware, kind=kind))
        return shard.load_model(space, bucket, hardware,
                                bind_space=bind_space, kind=kind)

    def save_model(self, space: str, bucket: str, hardware: str,
                   model: TPPCModel,
                   model_space: Optional[TuningSpace] = None,
                   revision: Optional[int] = None,
                   n_obs: Optional[int] = None,
                   kind: Optional[str] = None) -> None:
        shard, i = self._shard(store_key(space, bucket, hardware, kind=kind))
        shard.save_model(space, bucket, hardware, model,
                         model_space=model_space, revision=revision,
                         n_obs=n_obs, kind=kind)
        self._touched(i)

    def nearest_model_key(self, space: str, bucket: str, hardware: str,
                          kind: Optional[str] = None) -> Optional[str]:
        """Same portability tiering as ``ConfigStore``, over ALL shards.

        Exact hit short-circuits to the owning shard; otherwise the tier
        scan runs over the union of every shard's model keys (sorted, so
        ties break identically to the single-file store) — never
        crossing problem kinds.
        """
        exact = store_key(space, bucket, hardware, kind=kind)
        want_kind = split_key(exact)[0]
        shard, _ = self._shard(exact)
        if shard.get_model_dict(space, bucket, hardware,
                                kind=kind) is not None:
            return exact
        # union of the shards' (kind, space) index buckets — only keys
        # that can possibly match, sorted so ties break identically to
        # the single-file store
        first_bucket = first_hw = first_space = None
        for k in sorted(k for s_ in self._shards
                        for k in s_._model_index.get((want_kind, space), ())):
            _, _, b, h = split_key(k)
            if b == bucket:
                if first_bucket is None:
                    first_bucket = k
                    break
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
        """Every compatible-space model key over ALL shards, most
        preferred first — same contract as
        ``ConfigStore.transfer_candidates`` (similarity rank, ties
        toward same bucket, then same hardware, then sorted key order;
        shard layout never affects the ranking)."""
        found: List[Tuple[Tuple, str, float]] = []
        for shard in self._shards:
            for (kk, s), keys in sorted(shard._model_index.items()):
                if kk != signature.kind or s == signature.space:
                    continue
                for k in keys:
                    sig = shard.model_signature(k)
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
        """Fifth warm-start tier over ALL shards — same contract as
        ``ConfigStore.nearest_transfer_key``."""
        cands = self.transfer_candidates(signature, bucket, hardware,
                                         threshold=threshold)
        return cands[0] if cands else None

    def load_nearest_model(self, space: str, bucket: str, hardware: str,
                           bind_space: Optional[TuningSpace] = None,
                           kind: Optional[str] = None
                           ) -> Tuple[Optional[TPPCModel], Optional[str]]:
        key = self.nearest_model_key(space, bucket, hardware, kind=kind)
        if key is None:
            return None, None
        kk, s, b, h = split_key(key)
        shard, _ = self._shard(key)
        return shard.load_model(s, b, h, bind_space=bind_space,
                                kind=kk), key

    def load_transfer_model(self, signature: SpaceSignature,
                            bucket: str, hardware: str,
                            bind_space: TuningSpace,
                            threshold: float = DEFAULT_TRANSFER_THRESHOLD
                            ) -> Tuple[Optional[TransferredModel],
                                       Optional[str], float]:
        """``(model, key, similarity)`` — sharded twin of
        ``ConfigStore.load_transfer_model``."""
        found = self.nearest_transfer_key(signature, bucket, hardware,
                                          threshold=threshold)
        if found is None:
            return None, None, 0.0
        key, sim = found
        shard, _ = self._shard(key)
        try:
            model = rebind_model_dict(shard._models[key], bind_space,
                                      signature, source_key=key,
                                      similarity=sim)
        except (ValueError, KeyError, TypeError):
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
        """Similarity-weighted committee over every compatible artifact
        across ALL shards — sharded twin of
        ``ConfigStore.load_transfer_ensemble``."""
        from repro_torch.core.model import TransferEnsemble

        members = []
        for key, sim in self.transfer_candidates(signature, bucket,
                                                 hardware,
                                                 threshold=threshold):
            shard, _ = self._shard(key)
            try:
                members.append((rebind_model_dict(
                    shard._models[key], bind_space, signature,
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
    def save(self, merge: bool = True, force: bool = False) -> str:
        """Flush dirty shards (locked read-merge-write each); return root.

        Each shard flush goes through ``ConfigStore.save``'s amortized
        path — clean shards no-op, single-writer shards skip the
        read-back, multi-writer shards delta-write only changed keys."""
        for i in sorted(self._dirty):
            self._shards[i].save(merge=merge, force=force)
        self._dirty.clear()
        return self.root

    @property
    def save_stats(self) -> Dict[str, Any]:
        """Save-path counters summed across shards (``last_s`` is the
        slowest single shard save, not a sum)."""
        totals: Dict[str, Any] = {"saves": 0, "noop": 0, "full": 0,
                                  "delta": 0, "merged_reads": 0,
                                  "last_s": 0.0, "total_s": 0.0}
        for s in self._shards:
            for k, v in s.save_stats.items():
                if k == "last_s":
                    totals[k] = max(totals[k], v)
                else:
                    totals[k] = totals.get(k, 0) + v
        totals["last_s"] = round(totals["last_s"], 9)
        totals["total_s"] = round(totals["total_s"], 9)
        return totals

    def refresh(self) -> None:
        """Merge other processes' on-disk writes into memory, all shards.

        Reads are safe without the lock — shard writes land via atomic
        ``os.replace`` — and merging (rather than reloading) preserves
        our own unflushed mutations under the usual conflict rules.
        """
        for shard in self._shards:
            if os.path.exists(shard.path):
                d = shard._read_checked(shard.path)
                if d is not None:     # damaged shard: quarantined, skipped
                    shard._merge_from(d)

    def prune(self, keep_hardware=None, keep_spaces=None,
              keep_buckets=None, keep_kinds=None,
              dry_run: bool = False) -> Dict[str, int]:
        """Per-shard ``ConfigStore.prune``, stats aggregated across shards.

        A real (non-dry) prune persists each affected shard immediately —
        inside the underlying store's locked post-merge re-filter — even
        when the facade is in batching mode, because a deferred merging
        save would re-adopt the pruned keys from disk.
        """
        totals = {"dropped_entries": 0, "kept_entries": 0,
                  "dropped_models": 0, "kept_models": 0, "dropped": 0}
        for shard in self._shards:
            was = shard.autosave
            shard.autosave = not dry_run
            try:
                stats = shard.prune(keep_hardware=keep_hardware,
                                    keep_spaces=keep_spaces,
                                    keep_buckets=keep_buckets,
                                    keep_kinds=keep_kinds,
                                    dry_run=dry_run)
            finally:
                shard.autosave = was
            for k in totals:
                totals[k] += stats[k]
        return totals
