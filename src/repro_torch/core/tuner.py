"""Tuning orchestration: training phase, autotuning phase, experiment stats.

Mirrors the paper's two-phase architecture (Fig. 2):

  training phase:  sample/exhaust a tuning space on ANY hardware+input →
                   build a TP→PC_ops model (portable);
  autotuning:      profile → bottlenecks → ΔPC → score → biased step
                   on the hardware+input OF INTEREST.

Also provides the experiment harness used by benchmarks/: repeated stochastic
searches (1000x in the paper) with steps-to-well-performing statistics and
convergence-in-time traces.

The session-oriented public API lives in ``repro_torch.tuning`` (``TuningSession``,
``SEARCHERS``); ``autotune`` below remains as a one-call shim over it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core import counters as C
from repro_torch.core.evaluate import RecordedSpace, ReplayEvaluator
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.model import (DecisionTreeModel, ExactCounterModel,
                                    QuadraticRegressionModel, TPPCModel,
                                    deliberate_training_sample,
                                    prediction_matrix)
from repro_torch.core.searcher import ProfileBasedSearcher, Searcher
from repro_torch.core.tuning_space import Config, TuningSpace

WELL_PERFORMING_FACTOR = 1.1  # paper §4.1


def predicted_runtimes(model: TPPCModel, space: TuningSpace,
                       hw: HardwareSpec) -> np.ndarray:
    """Whole-space predicted runtimes: the portable model's PC_ops
    predictions priced through the cost model on ``hw``.

    The warm-start substrate shared by the serving tuner's ranking and the
    fleet's ``predicted_runtime_order``: negative predictions are clamped
    to zero and non-ops columns dropped before pricing.  One scalar
    ``costmodel.execute`` per config — fine at serving/fleet space sizes
    (tens to ~1k); batch ``execute`` before pointing this at paper-scale
    (200k) spaces.
    """
    names, mat = prediction_matrix(model, space)
    pred = np.empty(len(space), dtype=np.float64)
    for i in range(len(space)):
        ops = {k: max(0.0, float(v)) for k, v in zip(names, mat[i])
               if k in C.PC_OPS}
        pred[i] = costmodel.execute(ops, hw).runtime
    return pred


# =============================================================================
# Training phase
# =============================================================================
def train_model(
    recorded: RecordedSpace,
    kind: str = "tree",
    sample: Optional[Sequence[int]] = None,
    seed: int = 0,
) -> TPPCModel:
    """Build a portable TP→PC_ops model from (possibly partial) tuning data.

    kind: 'tree' (§3.4.2), 'quadratic' (§3.4.1) or 'exact' (§4.3 replay).
    ``sample``: indices of the explored part of the space (defaults to all —
    the paper also trains on complete spaces).
    """
    space = recorded.space
    if kind == "exact":
        return ExactCounterModel(space, recorded.ops_list())
    idxs = list(sample) if sample is not None else list(range(len(space)))
    cfgs = [space[i] for i in idxs]
    ops = [recorded.counters[i].ops for i in idxs]
    if kind == "tree":
        return DecisionTreeModel(space, cfgs, ops,
                                 rng=np.random.default_rng(seed))
    if kind == "quadratic":
        return QuadraticRegressionModel(space, cfgs, ops)
    raise ValueError(f"unknown model kind {kind!r}")


def train_model_deliberate(
    recorded: RecordedSpace, kind: str = "tree", seed: int = 0
) -> TPPCModel:
    """Training on the deliberate 2-3-values-per-parameter sample (§3.4.1)."""
    sample = deliberate_training_sample(recorded.space,
                                        rng=np.random.default_rng(seed))
    return train_model(recorded, kind=kind, sample=sample, seed=seed)


# =============================================================================
# Experiment harness (paper §4 methodology)
# =============================================================================
@dataclasses.dataclass
class SearchStats:
    searcher: str
    steps_to_well: List[int]
    times_to_well: List[float]
    never_found: int

    @property
    def runs(self) -> int:
        return len(self.steps_to_well) + self.never_found

    @property
    def found_rate(self) -> float:
        """Fraction of repetitions that reached a well-performing config."""
        return len(self.steps_to_well) / self.runs if self.runs else 0.0

    @property
    def mean_steps(self) -> float:
        return float(np.mean(self.steps_to_well)) if self.steps_to_well else float("nan")

    @property
    def median_steps(self) -> float:
        return float(np.median(self.steps_to_well)) if self.steps_to_well else float("nan")

    @property
    def mean_time(self) -> float:
        return float(np.mean(self.times_to_well)) if self.times_to_well else float("nan")

    def summary(self) -> str:
        """Human-readable line; explicit about never-found runs instead of
        letting NaN means leak into reports."""
        if not self.steps_to_well:
            return (f"{self.searcher}: never found a well-performing config "
                    f"in {self.runs} runs")
        line = (f"{self.searcher}: mean {self.mean_steps:.1f} / median "
                f"{self.median_steps:.1f} steps to well-performing")
        if self.never_found:
            line += f" ({self.never_found}/{self.runs} runs never found)"
        return line


def steps_to_well_performing(
    ev, threshold: float
) -> Tuple[Optional[int], Optional[float]]:
    """First empirical test reaching runtime <= threshold: (steps, elapsed).

    Works on any evaluator implementing the shared protocol (reads the
    public trace).
    """
    for steps, elapsed, rt in ev.trace:
        if rt <= threshold:
            return steps, elapsed
    return None, None


def run_search_experiment(
    searcher_factory: Callable[[int], Searcher],
    recorded: RecordedSpace,
    repeats: int = 1000,
    max_steps: Optional[int] = None,
    well_factor: float = WELL_PERFORMING_FACTOR,
) -> SearchStats:
    """Repeat a stochastic search ``repeats`` times (paper: 1000)."""
    threshold = recorded.best_runtime * well_factor
    cap = max_steps if max_steps is not None else len(recorded.space)
    steps_list: List[int] = []
    times_list: List[float] = []
    never = 0
    name = ""
    for rep in range(repeats):
        searcher = searcher_factory(rep)
        name = searcher.name
        ev = ReplayEvaluator(recorded)
        searcher.search(ev, max_steps=cap)
        s, t = steps_to_well_performing(ev, threshold)
        if s is None:
            never += 1
        else:
            steps_list.append(s)
            times_list.append(t)
    return SearchStats(searcher=name, steps_to_well=steps_list,
                       times_to_well=times_list, never_found=never)


def convergence_curve(
    searcher_factory: Callable[[int], Searcher],
    recorded: RecordedSpace,
    repeats: int = 100,
    max_steps: Optional[int] = None,
    time_grid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Average best-runtime-so-far at each second of tuning (paper Figs 3-8).

    Returns (time_grid, mean_curve, std_curve).  Curves start at the first
    instant when *all* repetitions have at least one finished kernel (§4.6.1).
    Repetitions that never finished a kernel are excluded; if none did, the
    curves are all-NaN over the given (or empty) grid rather than raising.
    """
    cap = max_steps if max_steps is not None else len(recorded.space)
    traces = []
    for rep in range(repeats):
        searcher = searcher_factory(rep)
        ev = ReplayEvaluator(recorded)
        searcher.search(ev, max_steps=cap)
        traces.append(ev.trace)
    traces = [tr for tr in traces if tr]
    if not traces:
        grid = (np.asarray(time_grid, dtype=np.float64)
                if time_grid is not None else np.empty(0))
        nan = np.full(grid.shape, np.nan)
        return grid, nan, nan.copy()
    first_done = max(tr[0][1] for tr in traces)
    t_end = max(tr[-1][1] for tr in traces)
    if time_grid is None:
        time_grid = np.linspace(first_done, t_end, 200)
    curves = np.empty((len(traces), time_grid.size))
    for i, tr in enumerate(traces):
        times = np.array([e for _, e, _ in tr])
        bests = np.minimum.accumulate(np.array([r for _, _, r in tr]))
        # best finished kernel at each grid time
        pos = np.searchsorted(times, time_grid, side="right") - 1
        pos = np.clip(pos, 0, len(bests) - 1)
        curves[i] = bests[pos]
        curves[i][time_grid < times[0]] = np.nan
    mean = np.nanmean(curves, axis=0)
    std = np.nanstd(curves, axis=0)
    return time_grid, mean, std


# =============================================================================
# High-level API: one-call shim over repro_torch.tuning.TuningSession
# =============================================================================
@dataclasses.dataclass
class TuneResult:
    best_config: Config
    best_runtime: float
    steps: int
    history: List[Tuple[int, float]]


def autotune(
    space: TuningSpace,
    workload_fn: Callable[[Config], Dict[str, float]],
    hw: HardwareSpec,
    model: Optional[TPPCModel] = None,
    train_hw: Optional[HardwareSpec] = None,
    budget: int = 60,
    model_kind: str = "tree",
    seed: int = 0,
    searcher_cls: type = ProfileBasedSearcher,
) -> TuneResult:
    """One-call autotuning: train (if no model given) then search.

    ``train_hw`` lets the model be built on different (virtual) hardware than
    the autotuning target — the paper's headline capability.  Thin shim over
    ``repro_torch.tuning.TuningSession`` kept for the one-liner use case.
    """
    # tuning builds on core
    from repro_torch.tuning.session import TuningSession

    session = TuningSession(space, workload_fn, hw, model=model, seed=seed)
    if session.model is None:
        session.train(train_hw=train_hw, kind=model_kind)
    return session.tune(budget=budget, searcher=searcher_cls)
