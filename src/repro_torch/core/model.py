"""Models of the TP → PC_ops relation (paper §3.4).

Two model families, both implemented from scratch on numpy:

* ``DecisionTreeModel`` (§3.4.2): regression trees built top-down greedily
  (ID3-style with Standard Deviation Reduction == MSE split criterion).  A
  candidate set of trees with varying structural hyperparameters is trained on
  a random 50% of the explored space, evaluated on the other 50%, and the tree
  with the lowest MAE (ties broken by RMSE) is selected — per counter.

* ``QuadraticRegressionModel`` (§3.4.1): per binary-parameter subspace,
  least-squares fit over main effects, pairwise interactions and quadratic
  terms of the non-binary parameters.  Training points are sampled
  deliberately: 2-3 values per non-binary parameter.

Models are trained once (on any hardware/input — the portability thesis) and
predict all PC_ops counters for unseen configurations.

Every model answers two prediction questions:

* ``predict(cfg) -> Dict[str, float]`` — one configuration (kept for
  single-config call sites and as the golden scalar reference);
* ``predict_matrix(space) -> n_configs × n_counters ndarray`` — the whole
  space at once, column j holding counter ``counter_names[j]``.  Algorithm 1
  re-scores the entire space at every profiling step, so this is the shape
  the searcher actually consumes; ``prediction_matrix`` below memoizes it
  per (model, space) so repeated searches (the paper's 1000 repetitions)
  compute it exactly once.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import counters as C
from repro_torch.core.tuning_space import TuningSpace

# Counters the models learn (the portable PC_ops set).  CTAS and SMEM_WS are
# included: they are statically known, making the model's job easy for them —
# the paper likewise feeds thread counts through the model path.
MODELED_COUNTERS: Tuple[str, ...] = C.PC_OPS


def _dicts_to_matrix(dicts: Sequence[Dict[str, float]],
                     names: Sequence[str]) -> np.ndarray:
    """Stack per-config counter dicts into an (n × len(names)) ndarray,
    missing counters filling as 0.0 (== outside PC_used for scoring)."""
    out = np.zeros((len(dicts), len(names)), dtype=np.float64)
    for j, name in enumerate(names):
        out[:, j] = [d.get(name, 0.0) for d in dicts]
    return out


class TPPCModel:
    """Interface: predict PC_ops for a configuration / a whole space."""

    # structural space signature of the space the model was trained on
    # (``repro_torch.tuning.signature.SpaceSignature``); bound by the
    # serializer on load and by training call sites that know it.  None
    # on models that predate signatures — the serializer recomputes it
    # from the artifact's recorded parameters.
    signature = None

    def predict(self, cfg: Dict) -> Dict[str, float]:
        raise NotImplementedError

    def predict_many(self, cfgs: Sequence[Dict]) -> List[Dict[str, float]]:
        return [self.predict(c) for c in cfgs]

    @property
    def counter_names(self) -> Tuple[str, ...]:
        """Column order of ``predict_matrix``."""
        raise NotImplementedError

    def predict_matrix(self, space: Optional[TuningSpace] = None) -> np.ndarray:
        """``len(space) × len(counter_names)`` predictions for every config.

        Generic fallback: loops ``predict``.  Concrete models override with
        batched array implementations.
        """
        space = space if space is not None else self.space
        return _dicts_to_matrix(self.predict_many(space.configs),
                                self.counter_names)


# =============================================================================
# Shared prediction-matrix cache (model- and space-keyed)
# =============================================================================
# model (weak) -> {id(space): (weakref(space), counter_names, matrix)}.
# Searchers are re-instantiated per repetition in the experiment harness;
# predictions are repetition-invariant, so the matrix must outlive searchers
# but die with the model.
_PRED_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _compute_prediction_matrix(model, space: TuningSpace):
    try:
        # probed separately so a real bug inside predict_matrix() below
        # propagates instead of silently degrading to the per-config loop
        names: Optional[Tuple[str, ...]] = tuple(model.counter_names)
    except (AttributeError, NotImplementedError):
        names = None
    if names is not None and hasattr(model, "predict_matrix"):
        matrix = np.asarray(model.predict_matrix(space), dtype=np.float64)
        # column-major: score_space works column-wise, so per-counter slices
        # must be contiguous (same values, ~4x faster scoring on big spaces)
        matrix = np.asfortranarray(matrix)
    else:
        # model exposing only .predict (duck-typed, or a minimal TPPCModel
        # subclass that never declared counter_names): materialize per config
        preds = [model.predict(space[i]) for i in range(len(space))]
        names_l: List[str] = []
        seen = set()
        for d in preds:
            for k in d:
                if k not in seen:
                    seen.add(k)
                    names_l.append(k)
        names = tuple(names_l)
        matrix = _dicts_to_matrix(preds, names)
    matrix.setflags(write=False)
    return names, matrix


def prediction_matrix(model, space: TuningSpace
                      ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Memoized (counter_names, n_configs × n_counters) for model × space.

    The matrix is read-only and shared: every searcher instance over the same
    (model, space) pair — e.g. the 1000 repetitions of one experiment —
    reuses the same array.
    """
    try:
        per_model = _PRED_CACHE.get(model)
        if per_model is None:
            per_model = {}
            _PRED_CACHE[model] = per_model
    except TypeError:  # unhashable / non-weakrefable model
        return _compute_prediction_matrix(model, space)
    key = id(space)
    entry = per_model.get(key)
    if entry is not None:
        ref, names, matrix = entry
        if ref() is space:
            return names, matrix
    names, matrix = _compute_prediction_matrix(model, space)

    def _evict(dead_ref, per_model=per_model, key=key):
        # drop the dead space's matrix now rather than holding it for the
        # model's lifetime; guard against the id having been reused
        cur = per_model.get(key)
        if cur is not None and cur[0] is dead_ref:
            del per_model[key]

    per_model[key] = (weakref.ref(space, _evict), names, matrix)
    return names, matrix


# =============================================================================
# Decision tree regression (from scratch)
# =============================================================================
@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.left is None


def _best_split(X: np.ndarray, y: np.ndarray, min_samples: int):
    """Lowest-SSE (feature, threshold) via cumulative sums, O(n log n)/feature.

    For each feature the samples are sorted once; left/right SSE at every
    candidate threshold (midpoints between consecutive distinct values) comes
    from prefix sums of y and y² — replacing the former O(n²·p) rescan.
    Ties keep the lowest threshold of the earliest feature (same scan order
    as before; note the prefix-sum SSE rounds differently from the old
    two-pass sum, so exact-tie resolution — and hence trained trees — can
    differ from a two-pass SSE tree at fp round-off).

    y is centered first: SSE is shift-invariant, and on near-constant
    targets the raw ``Σy² − (Σy)²/n`` form cancels catastrophically
    (negative SSEs → phantom splits fitting float noise).
    """
    n = y.size
    y = y - y.mean()
    best = None  # (sse, feature, threshold)
    for f in range(X.shape[1]):
        order = np.argsort(X[:, f], kind="stable")
        xo = X[order, f]
        yo = y[order]
        cut = np.flatnonzero(xo[1:] != xo[:-1])  # left block = [0 .. cut]
        if cut.size == 0:
            continue
        nl = cut + 1
        nr = n - nl
        valid = (nl >= min_samples) & (nr >= min_samples)
        if not valid.any():
            continue
        c1 = np.cumsum(yo)
        c2 = np.cumsum(yo * yo)
        s1l, s2l = c1[cut], c2[cut]
        s1r, s2r = c1[-1] - s1l, c2[-1] - s2l
        sse = np.maximum(s2l - s1l * s1l / nl, 0.0) \
            + np.maximum(s2r - s1r * s1r / nr, 0.0)
        sse[~valid] = np.inf
        i = int(np.argmin(sse))
        if best is None or sse[i] < best[0]:
            t = (xo[cut[i]] + xo[cut[i] + 1]) / 2.0
            best = (float(sse[i]), f, float(t))
    return best


def _build_tree(
    X: np.ndarray,
    y: np.ndarray,
    depth: int,
    max_depth: int,
    min_samples: int,
) -> _Node:
    node = _Node(value=float(y.mean()) if y.size else 0.0)
    if depth >= max_depth or y.size < 2 * min_samples or np.all(y == y[0]):
        return node
    base_sse = float(((y - y.mean()) ** 2).sum())
    best = _best_split(X, y, min_samples)
    if best is None or best[0] >= base_sse - 1e-12:
        return node
    _, f, t = best
    lm = X[:, f] <= t
    node.feature, node.threshold = f, t
    node.left = _build_tree(X[lm], y[lm], depth + 1, max_depth, min_samples)
    node.right = _build_tree(X[~lm], y[~lm], depth + 1, max_depth, min_samples)
    return node


def _tree_predict(node: _Node, x: np.ndarray) -> float:
    while not node.is_leaf:
        node = node.left if x[node.feature] <= node.threshold else node.right
    return node.value


def _tree_predict_batch(node: _Node, X: np.ndarray) -> np.ndarray:
    """All rows of X through one tree, partitioning index sets iteratively.

    Identical leaf assignment to ``_tree_predict`` row by row (the same
    ``<=`` comparisons), without the per-row Python descent.
    """
    out = np.empty(X.shape[0], dtype=np.float64)
    stack = [(node, np.arange(X.shape[0]))]
    while stack:
        nd, idx = stack.pop()
        if idx.size == 0:
            continue
        if nd.is_leaf:
            out[idx] = nd.value
        else:
            lm = X[idx, nd.feature] <= nd.threshold
            stack.append((nd.left, idx[lm]))
            stack.append((nd.right, idx[~lm]))
    return out


# Candidate structural hyperparameters ("we also alter parent nodes" §3.4.2).
_TREE_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (4, 2), (6, 2), (8, 1), (10, 1), (12, 1), (16, 1),
)


class DecisionTreeModel(TPPCModel):
    """One selected regression tree per PC_ops counter (§3.4.2)."""

    def __init__(
        self,
        space: TuningSpace,
        cfgs: Sequence[Dict],
        counters: Sequence[Dict[str, float]],
        rng: Optional[np.random.Generator] = None,
        counters_to_model: Sequence[str] = MODELED_COUNTERS,
    ):
        rng = rng or np.random.default_rng(0)
        self.space = space
        X = space.vectorize_configs(cfgs)
        n = X.shape[0]
        self.trees: Dict[str, _Node] = {}
        self.scale: Dict[str, float] = {}
        perm = rng.permutation(n)
        half = max(1, n // 2)
        tr, te = perm[:half], perm[half:]
        if te.size == 0:
            te = tr
        for name in counters_to_model:
            y = np.array([float(cs.get(name, 0.0)) for cs in counters])
            # scale to O(1) for numerically comparable MAE across counters
            scale = float(np.abs(y).max()) or 1.0
            ys = y / scale
            best = None  # (mae, rmse, tree)
            for max_depth, min_samples in _TREE_CANDIDATES:
                tree = _build_tree(X[tr], ys[tr], 0, max_depth, min_samples)
                err = _tree_predict_batch(tree, X[te]) - ys[te]
                mae = float(np.abs(err).mean())
                rmse = float(np.sqrt((err**2).mean()))
                if best is None or (mae, rmse) < (best[0], best[1]):
                    best = (mae, rmse, tree)
            self.trees[name] = best[2]
            self.scale[name] = scale

    @property
    def counter_names(self) -> Tuple[str, ...]:
        return tuple(self.trees)

    def predict(self, cfg: Dict) -> Dict[str, float]:
        x = np.asarray(self.space.vectorize(cfg), dtype=np.float64)
        return {
            name: _tree_predict(tree, x) * self.scale[name]
            for name, tree in self.trees.items()
        }

    def predict_matrix(self, space: Optional[TuningSpace] = None) -> np.ndarray:
        space = space if space is not None else self.space
        # features must be encoded by the MODEL's space (cross-space search:
        # a model from the reduced GEMM space scoring the full space)
        X = (space.feature_matrix if space is self.space
             else self.space.vectorize_configs(space.configs))
        out = np.empty((X.shape[0], len(self.trees)), dtype=np.float64)
        for j, name in enumerate(self.counter_names):
            out[:, j] = _tree_predict_batch(self.trees[name], X) \
                * self.scale[name]
        return out

    @classmethod
    def from_state(
        cls, space: TuningSpace, trees: Dict[str, _Node],
        scale: Dict[str, float],
    ) -> "DecisionTreeModel":
        """Rebuild a trained model from serialized state (no re-training)."""
        obj = cls.__new__(cls)
        obj.space = space
        obj.trees = trees
        obj.scale = scale
        return obj


# =============================================================================
# Least-squares quadratic regression per binary subspace (§3.4.1)
# =============================================================================
def _poly_features(v: np.ndarray) -> np.ndarray:
    """[1, x_i, x_i^2, x_i*x_j] feature expansion."""
    feats = [1.0]
    k = v.size
    feats.extend(v.tolist())
    feats.extend((v**2).tolist())
    for i in range(k):
        for j in range(i + 1, k):
            feats.append(v[i] * v[j])
    return np.asarray(feats)


def _poly_features_batch(V: np.ndarray) -> np.ndarray:
    """Row-wise ``_poly_features``: (m × k) -> (m × n_feats)."""
    m, k = V.shape
    cols = [np.ones((m, 1)), V, V * V]
    for i in range(k):
        for j in range(i + 1, k):
            cols.append((V[:, i] * V[:, j])[:, None])
    return np.concatenate(cols, axis=1)


class QuadraticRegressionModel(TPPCModel):
    """Least-squares non-linear regression per binary subspace (§3.4.1)."""

    def __init__(
        self,
        space: TuningSpace,
        cfgs: Sequence[Dict],
        counters: Sequence[Dict[str, float]],
        counters_to_model: Sequence[str] = MODELED_COUNTERS,
    ):
        self.space = space
        self._counter_names = tuple(counters_to_model)
        nb = space.nonbinary_parameters
        self._nb_names = [p.name for p in nb]
        X = space.vectorize_configs(cfgs)
        nb_cols = [j for j, p in enumerate(space.parameters)
                   if not p.is_binary]
        bin_cols = [j for j, p in enumerate(space.parameters) if p.is_binary]
        V = X[:, nb_cols]
        keys = [tuple(r) for r in
                X[:, bin_cols].astype(np.int64).tolist()]
        # group samples by binary subspace
        groups: Dict[Tuple, List[int]] = {}
        for i, key in enumerate(keys):
            groups.setdefault(key, []).append(i)
        self.coefs: Dict[Tuple, Dict[str, np.ndarray]] = {}
        self._fallback: Dict[str, float] = {
            name: float(
                np.mean([cs.get(name, 0.0) for cs in counters]) if counters else 0.0
            )
            for name in counters_to_model
        }
        for key, idxs in groups.items():
            Xf = _poly_features_batch(V[np.asarray(idxs)])
            per_counter: Dict[str, np.ndarray] = {}
            for name in counters_to_model:
                y = np.array([float(counters[i].get(name, 0.0)) for i in idxs])
                coef, *_ = np.linalg.lstsq(Xf, y, rcond=None)
                per_counter[name] = coef
            self.coefs[key] = per_counter
        self._coef_mats: Dict[Tuple, np.ndarray] = {}

    @property
    def counter_names(self) -> Tuple[str, ...]:
        return self._counter_names

    def _nb_vector(self, cfg: Dict) -> np.ndarray:
        full = dict(zip([p.name for p in self.space.parameters],
                        self.space.vectorize(cfg)))
        return np.asarray([full[n] for n in self._nb_names], dtype=np.float64)

    def predict(self, cfg: Dict) -> Dict[str, float]:
        key = self.space.subspace_key(cfg)
        if key not in self.coefs:
            return dict(self._fallback)
        feats = _poly_features(self._nb_vector(cfg))
        return {
            name: float(feats @ coef)
            for name, coef in self.coefs[key].items()
        }

    def _coef_matrix(self, key: Tuple) -> np.ndarray:
        """(n_feats × n_counters) stacked coefficients of one subspace."""
        mat = self._coef_mats.get(key)
        if mat is None:
            per = self.coefs[key]
            mat = np.stack([per[name] for name in self._counter_names],
                           axis=1)
            self._coef_mats[key] = mat
        return mat

    def predict_matrix(self, space: Optional[TuningSpace] = None) -> np.ndarray:
        space = space if space is not None else self.space
        if space is self.space:
            X = space.feature_matrix
            keys = space.subspace_keys()
        else:
            X = self.space.vectorize_configs(space.configs)
            keys = [self.space.subspace_key(c) for c in space.configs]
        nb_cols = [j for j, p in enumerate(self.space.parameters)
                   if not p.is_binary]
        V = X[:, nb_cols]
        out = np.empty((len(keys), len(self._counter_names)),
                       dtype=np.float64)
        fallback = np.array([self._fallback[n] for n in self._counter_names])
        groups: Dict[Tuple, List[int]] = {}
        for i, key in enumerate(keys):
            groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            rows = np.asarray(idxs)
            if key in self.coefs:
                out[rows] = _poly_features_batch(V[rows]) \
                    @ self._coef_matrix(key)
            else:
                out[rows] = fallback
        return out

    @classmethod
    def from_state(
        cls,
        space: TuningSpace,
        counter_names: Sequence[str],
        coefs: Dict[Tuple, Dict[str, np.ndarray]],
        fallback: Dict[str, float],
    ) -> "QuadraticRegressionModel":
        """Rebuild a trained model from serialized state (no re-fitting)."""
        obj = cls.__new__(cls)
        obj.space = space
        obj._counter_names = tuple(counter_names)
        obj._nb_names = [p.name for p in space.nonbinary_parameters]
        obj.coefs = coefs
        obj._fallback = dict(fallback)
        obj._coef_mats = {}
        return obj


# =============================================================================
# Exact "model": reads recorded counters (paper §4.3 — eliminates model error)
# =============================================================================
class ExactCounterModel(TPPCModel):
    """Replays exhaustively-measured PC_ops (no ML prediction error)."""

    def __init__(self, space: TuningSpace, counters: Sequence[Dict[str, float]]):
        self.space = space
        self._by_index = [dict(cs) for cs in counters]
        self._index: Optional[Dict[Tuple, int]] = None
        self._remap: Optional[np.ndarray] = None
        self._counter_names: Optional[Tuple[str, ...]] = None

    @property
    def counter_names(self) -> Tuple[str, ...]:
        if self._counter_names is None:
            names = list(C.PC_OPS)
            seen = set(names)
            for d in self._by_index:
                for k in d:
                    if k not in seen:
                        seen.add(k)
                        names.append(k)
            self._counter_names = tuple(names)
        return self._counter_names

    def _record_index(self, idx: int) -> int:
        """Space index -> position in the recorded counters list."""
        if self._remap is None:
            return idx
        rec = int(self._remap[idx])
        if rec < 0:
            raise KeyError(f"config not in recorded pairs: {self.space[idx]}")
        return rec

    def predict(self, cfg: Dict) -> Dict[str, float]:
        try:
            return self._by_index[self._record_index(self.space.index_of(cfg))]
        except KeyError:
            if self._index is not None:  # cfg outside the bound space but in
                # the recorded pairs (differently-pruned space)
                return self._by_index[self._index[tuple(sorted(cfg.items()))]]
            raise

    def predict_index(self, idx: int) -> Dict[str, float]:
        return self._by_index[self._record_index(idx)]

    def predict_matrix(self, space: Optional[TuningSpace] = None) -> np.ndarray:
        space = space if space is not None else self.space
        if space is self.space:
            recs = [self._by_index[self._record_index(i)]
                    for i in range(len(space))]
        else:
            recs = [self.predict(space[i]) for i in range(len(space))]
        return _dicts_to_matrix(recs, self.counter_names)

    @classmethod
    def from_pairs(
        cls, space: TuningSpace, configs: Sequence[Dict],
        counters: Sequence[Dict[str, float]],
    ) -> "ExactCounterModel":
        """Rebuild from explicit (config, counters) pairs — robust to the
        deserialized space enumerating configs in a different order.  The
        space-index → record remap is computed once here, so ``predict``
        stays an O(1) lookup instead of rebuilding a sorted key per call."""
        obj = cls(space, counters)
        obj._index = {tuple(sorted(c.items())): i
                      for i, c in enumerate(configs)}
        obj._remap = np.array(
            [obj._index.get(tuple(sorted(space[i].items())), -1)
             for i in range(len(space))], dtype=np.int64)
        return obj


# =============================================================================
# Cross-space transfer: rebind a trained model onto a DIFFERENT space
# =============================================================================
class _ConfigList:
    """Minimal space-shaped view over a list of config dicts.

    The concrete models' batched ``predict_matrix(space)`` paths only
    touch ``space.configs`` / ``space[i]`` / ``len(space)`` when the
    space is not their own — this shim lets ``TransferredModel`` reuse
    those batched paths on remapped configs without materializing a
    cross-product ``TuningSpace``.
    """

    def __init__(self, configs: Sequence[Dict]):
        self.configs = list(configs)

    def __len__(self) -> int:
        return len(self.configs)

    def __getitem__(self, i: int) -> Dict:
        return self.configs[i]


class TransferredModel(TPPCModel):
    """A trained TP→PC model rebound onto a space it was never fit on.

    The transfer mechanism of the cross-space warm start (paper §4.4/§4.5
    portability, extended across kernels per arXiv 2102.05299): a target
    config is translated into the source model's own space — each source
    parameter reads the target parameter its hashed slot mapped to
    (``param_map``: source parameter index → target parameter index),
    the raw value snapped to the nearest *declared* source value by
    feature code; unmapped source parameters pin to their median declared
    value — and predictions are restricted to the **shared-counter
    intersection**: only counters both spaces name are reported, so the
    downstream cost-model pricing never consumes a counter the target
    workload would not emit.

    The rebound model is a read-time construct (built by
    ``repro_torch.tuning.serialize.rebind_model_dict``); it is never
    re-serialized — a transferred job that completes trains and publishes
    a native model for its own key, which then outranks the transfer tier.
    """

    def __init__(self, source: TPPCModel, target_space: TuningSpace,
                 param_map: Dict[int, int],
                 counters: Optional[Sequence[str]] = None,
                 similarity: float = 0.0,
                 source_key: Optional[str] = None):
        self.source = source
        self.space = target_space
        self.source_space = source.space
        self.param_map = dict(param_map)
        src_names = tuple(source.counter_names)
        if counters is None:
            shared = src_names
        else:
            want = set(counters)
            shared = tuple(n for n in src_names if n in want)
        if not shared:      # nothing both spaces name: nothing to predict
            raise ValueError(
                "transfer has an empty shared-counter intersection: "
                f"source predicts {list(src_names)}, target names "
                f"{sorted(want)}")
        self._counter_names = shared
        self.similarity = float(similarity)
        self.source_key = source_key
        # per-source-parameter translation plan, built once
        self._plan: List[Tuple[Any, ...]] = []
        for i, p in enumerate(self.source_space.parameters):
            j = self.param_map.get(i)
            if j is None or j >= len(target_space.parameters):
                # unmapped slot: pin to the median declared value
                self._plan.append(("pin", p.name,
                                   p.values[len(p.values) // 2]))
                continue
            tp = target_space.parameters[j]
            codes = np.asarray([p.encode(v) for v in p.values],
                               dtype=np.float64)
            self._plan.append(("map", p.name, p, tp, codes))

    @property
    def counter_names(self) -> Tuple[str, ...]:
        return self._counter_names

    @staticmethod
    def _snap(p, tp, codes: np.ndarray, value):
        """Nearest declared source value for a target value: exact raw
        match when the value is in the source list, else nearest by
        feature code (the numeric shadow both models consume)."""
        try:
            if value in p.values:
                return value
        except TypeError:
            pass
        try:
            code = float(tp.encode(value))
        except (TypeError, ValueError):
            return p.values[len(p.values) // 2]
        return p.values[int(np.argmin(np.abs(codes - code)))]

    def translate(self, cfg: Dict) -> Dict:
        """Target-space config → the source-space config the wrapped
        model actually predicts for."""
        out: Dict = {}
        for step in self._plan:
            if step[0] == "pin":
                out[step[1]] = step[2]
            else:
                _, name, p, tp, codes = step
                out[name] = self._snap(p, tp, codes, cfg[tp.name])
        return out

    def predict(self, cfg: Dict) -> Dict[str, float]:
        pred = self.source.predict(self.translate(cfg))
        return {n: float(pred.get(n, 0.0)) for n in self._counter_names}

    def predict_matrix(self, space: Optional[TuningSpace] = None) -> np.ndarray:
        space = space if space is not None else self.space
        view = _ConfigList([self.translate(c) for c in space.configs])
        mat = np.asarray(self.source.predict_matrix(view),
                         dtype=np.float64)
        src_names = list(self.source.counter_names)
        cols = [src_names.index(n) for n in self._counter_names]
        return mat[:, cols]


class TransferEnsemble:
    """Similarity-weighted committee of rebound cross-space models.

    A single borrowed model's absolute runtime predictions are noisy on
    a space it was never fit on, but the parts of the ranking DIFFERENT
    source spaces agree on are exactly the structure that generalizes —
    a similarity-weighted blend of every compatible source's relative
    ranking is far more reliable at the head (where the warm start
    spends its trials) than the single most-similar source alone.

    ``members`` is ``[(TransferredModel, similarity), ...]``, best
    first; provenance (``source_key``/``similarity``) reports the top
    member.  Scoring lives in
    ``repro_torch.core.tuner.ensemble_runtime_scores`` — the committee itself
    is a read-time construct like its members and is never serialized.
    """

    def __init__(self, members: Sequence[Tuple["TransferredModel", float]]):
        if not members:
            raise ValueError("TransferEnsemble needs at least one member")
        self.members: List[Tuple["TransferredModel", float]] = \
            [(m, float(s)) for m, s in members]

    @property
    def top(self) -> "TransferredModel":
        return self.members[0][0]

    @property
    def source_key(self) -> Optional[str]:
        return self.top.source_key

    @property
    def similarity(self) -> float:
        return self.members[0][1]

    @property
    def counter_names(self) -> Tuple[str, ...]:
        return self.top.counter_names

    def __len__(self) -> int:
        return len(self.members)


def deliberate_training_sample(
    space: TuningSpace, values_per_param: int = 3,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """§3.4.1 sampling: 2-3 values per non-binary parameter, all binary combos.

    Returns indices into the space.  Keeps total combinations low while
    sampling each subspace evenly despite constraints.
    """
    rng = rng or np.random.default_rng(0)
    keep: Dict[str, set] = {}
    for p in space.nonbinary_parameters:
        vals = list(p.values)
        if len(vals) <= values_per_param:
            keep[p.name] = set(vals)
        else:
            # endpoints (+ middle when 3 values wanted) — even coverage
            picks = {vals[0], vals[-1]}
            if values_per_param >= 3:
                picks.add(vals[len(vals) // 2])
            while len(picks) < values_per_param:
                picks.add(vals[int(rng.integers(len(vals)))])
            keep[p.name] = picks
    # vectorized membership over the feature matrix (was a full Python scan)
    mask = np.ones(len(space), dtype=bool)
    fm = space.feature_matrix
    for j, p in enumerate(space.parameters):
        if p.name not in keep:
            continue
        if len({p.encode(v) for v in p.values}) == len(p.values):
            codes = np.array(sorted(p.encode(v) for v in keep[p.name]))
            mask &= np.isin(fm[:, j], codes)
        else:
            # non-injective encoding (parameter mixing strings/numerics):
            # feature codes would alias distinct values — match raw values
            kept = keep[p.name]
            mask &= np.fromiter((c[p.name] in kept for c in space.configs),
                                dtype=bool, count=len(space))
    return [int(i) for i in np.flatnonzero(mask)]
