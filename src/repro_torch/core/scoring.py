"""Configuration scoring (paper §3.6, Eqs. 16-17).

Scores unexplored configurations by whether the model predicts they move
PC_ops in the direction required by ΔPC_ops, then normalizes scores into
<0.0001, 256> for weighted random selection.

Sign convention note: paper Eq. 16 as printed reads
``Δpc_p · (pc_p(c_profile) − pc_p(c_candidate)) / (pc_p(c_profile) + pc_p(c_candidate))``
which, with Δpc < 0 meaning "decrease", would *penalize* candidates that
decrease the counter.  The text's intent (§3.6: "set higher scores to
configurations which are predicted to change PC_ops in the required way")
requires the candidate-minus-profile orientation, which we use:
score contribution = Δpc_p · (cand − prof)/(cand + prof)  — positive when the
predicted change matches the required direction.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

# Eq. 17 constants
GAMMA = -0.25        # cutoff threshold
EXPONENT = 8
FLOOR = 1e-4
CEIL = 256.0


def score_configuration(
    delta_pc: Dict[str, float],
    pc_profile: Dict[str, float],
    pc_candidate: Dict[str, float],
) -> float:
    """Raw score s of one candidate (Eq. 16).

    Only counters with non-zero predictions for both configurations are used
    (PC_used in the paper).
    """
    s = 0.0
    for name, dpc in delta_pc.items():
        if dpc == 0.0:
            continue
        p = float(pc_profile.get(name, 0.0))
        c = float(pc_candidate.get(name, 0.0))
        if p == 0.0 or c == 0.0:
            continue  # outside PC_used
        s += dpc * (c - p) / (c + p)
    return s


def score_space(
    delta_pc: Dict[str, float],
    pc_profile: np.ndarray,
    pred_matrix: np.ndarray,
    counter_index: Mapping[str, int],
    pc_used_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Eq. 16 for EVERY configuration at once (Algorithm 1 l.7).

    ``pred_matrix`` is a model's ``predict_matrix`` output (n_configs ×
    n_counters, columns named by ``counter_index``), ``pc_profile`` the row of
    the profiled configuration, and ``pc_used_mask`` an optional precomputed
    ``pred_matrix != 0`` (the PC_used membership — it only depends on the
    model, so searchers compute it once per search, not per profiling step).

    Accumulates per counter in ``delta_pc`` iteration order with masked
    contributions forced to 0.0, so the result is bit-for-bit what a
    ``score_configuration`` loop over the space produces — the vectorized
    searcher replays the scalar searcher's traces exactly.
    """
    if pc_used_mask is None:
        pc_used_mask = pred_matrix != 0.0
    s = np.zeros(pred_matrix.shape[0], dtype=np.float64)
    for name, dpc in delta_pc.items():
        if dpc == 0.0:
            continue
        j = counter_index.get(name)
        if j is None:
            continue  # counter not modeled: prediction 0 -> outside PC_used
        p = float(pc_profile[j])
        if p == 0.0:
            continue
        c = pred_matrix[:, j]
        with np.errstate(divide="ignore", invalid="ignore"):
            s += np.where(pc_used_mask[:, j], dpc * (c - p) / (c + p), 0.0)
    return s


def normalize_scores(scores: Sequence[float]) -> np.ndarray:
    """Eq. 17: map raw scores into <0.0001, 256> selection weights.

    Positive scores are amplified into <1, 256>; negative scores above the
    cutoff γ retain small non-zero probability (escape hatch from local
    optima / model error §3.6); scores at or below γ get the floor weight.
    """
    s = np.asarray(scores, dtype=np.float64)
    out = np.full(s.shape, FLOOR)
    if s.size == 0:
        return out
    s_max = float(s.max())
    s_min = float(s.min())

    pos = s > 0.0
    if s_max > 0.0:
        out[pos] = np.power(1.0 + s[pos] / s_max, EXPONENT)
    else:
        out[pos] = 1.0  # unreachable when s_max <= 0, kept for safety

    mid = (~pos) & (s > GAMMA)
    if s_min < 0.0:
        out[mid] = np.maximum(FLOOR, np.power(1.0 - s[mid] / s_min, EXPONENT))
    else:
        out[mid] = 1.0  # all-zero scores: uniform weight

    # s <= GAMMA stays at FLOOR
    return np.clip(out, FLOOR, CEIL)


def weighted_choice(
    weights: np.ndarray, rng: np.random.Generator, mask: np.ndarray
) -> int:
    """Sample an index with probability ∝ weight among mask==True entries.

    Mirrors Algorithm 1 lines 17-18 (already-evaluated entries carry weight 0
    via the mask).
    """
    w = np.where(mask, weights, 0.0)
    tot = w.sum()
    if tot <= 0.0:
        # nothing scoreable left — uniform over the mask
        idxs = np.flatnonzero(mask)
        if idxs.size == 0:
            raise RuntimeError("no unexplored configurations left")
        return int(rng.choice(idxs))
    # inlined ``rng.choice(len(w), p=w / tot)``: identical arithmetic and
    # identical rng-stream consumption (one ``random()`` draw), minus the
    # per-call probability re-validation — this runs once per biased step
    # over the whole space, so the O(n) constant matters.  Equivalence with
    # Generator.choice is pinned by tests/test_vectorized_golden.py.
    cdf = (w / tot).cumsum()
    cdf /= cdf[-1]
    return min(int(cdf.searchsorted(rng.random(), side="right")), len(w) - 1)
