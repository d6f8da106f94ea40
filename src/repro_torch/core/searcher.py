"""Tuning-space searchers in ask-tell form.

* ``ProfileBasedSearcher`` — the paper's contribution (Algorithm 1): biased
  weighted-random search navigated by performance counters, a portable
  TP→PC_ops model, and the bottleneck/ΔPC expert system.
* ``RandomSearcher`` — the paper's primary baseline.
* ``BasinHoppingSearcher`` — Kernel-Tuner-style global+local optimization
  (paper §4.7 comparison target).
* ``StarchartSearcher`` — recursive-partitioning surrogate model search
  (paper §4.8 comparison target).
* ``ProfileLocalSearcher`` — beyond-paper §3.9.1 gradient-following variant.

Every searcher exposes the same two-call interface:

    propose(k)            -> up to k ``Candidate``s to test next
    observe(observations) -> feed back the ``Observation``s for them

which makes Algorithm 1 resumable and inspectable mid-search, lets a search loop
batch empirical tests (``Evaluator.measure_many``), and removes every
special case from ``autotune``/benchmark call sites.  The legacy
``search(ev, max_steps)`` entry point remains as a thin shim over
``run_search``.

Internally each searcher writes its strategy as a plain generator
(``_plan``) that yields candidate batches and receives observation batches —
sequential algorithms (basin hopping's first-improvement descent) read
naturally while the base class handles the ask-tell bookkeeping.

Constructors are uniform: ``Searcher(space, seed=..., **strategy_kwargs)``,
and every concrete class registers itself in the string-keyed ``SEARCHERS``
registry (``repro_torch.tuning`` re-exports it):

    SEARCHERS["profile"](space, seed=3, model=m, cores=132)
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Type

import numpy as np

from repro_torch.core import bottleneck, reaction, scoring
from repro_torch.core.account import Candidate, Observation
from repro_torch.core.model import (TPPCModel, _build_tree,
                                    _tree_predict_batch, prediction_matrix)
from repro_torch.core.tuning_space import TuningSpace

# String-keyed registry of all searcher classes (the public lookup table).
SEARCHERS: Dict[str, Type["Searcher"]] = {}


def register_searcher(name: str):
    """Class decorator: register under ``name`` and set ``cls.name``."""

    def deco(cls: Type["Searcher"]) -> Type["Searcher"]:
        cls.name = name
        SEARCHERS[name] = cls
        return cls

    return deco


class Searcher:
    """Ask-tell base: plumbing between ``propose``/``observe`` and ``_plan``.

    ``_plan`` is a generator yielding non-empty candidate batches; each
    ``yield`` receives the list of ``Observation``s for exactly the
    candidates it yielded (in order).  A batch may be drained across several
    ``propose`` calls; the generator resumes only once the whole batch has
    been observed, so budget-truncated runs simply leave it suspended.
    """

    name = "base"

    def __init__(self, space: TuningSpace, seed: int = 0):
        self.space = space
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._gen: Optional[Iterator] = None
        self._queue: List[Candidate] = []   # current batch, not yet proposed
        self._outstanding = 0               # proposed, not yet observed
        self._obs: List[Observation] = []   # observed, not yet sent to _plan
        self._finished = False

    # -- strategy (implemented by subclasses) ----------------------------------
    def _plan(self):
        raise NotImplementedError

    # -- ask-tell --------------------------------------------------------------
    def propose(self, k: int) -> List[Candidate]:
        """Return up to ``k`` candidates to evaluate next ([] when done)."""
        if k <= 0:
            return []
        while not self._queue and not self._finished:
            if self._outstanding:
                return []   # waiting on observations for the current batch
            self._advance()
        return self._take(k)

    def observe(self, observations: Sequence[Observation]) -> None:
        """Feed back results for previously proposed candidates (in order)."""
        for o in observations:
            self._obs.append(o)
            self._outstanding -= 1
        if self._outstanding < 0:
            raise RuntimeError("observe() got results never proposed")

    @property
    def done(self) -> bool:
        """True once the strategy has no further candidates to offer."""
        return self._finished and not self._queue

    def _take(self, k: int) -> List[Candidate]:
        out, self._queue = self._queue[:k], self._queue[k:]
        self._outstanding += len(out)
        return out

    def _advance(self) -> None:
        """Resume the plan generator with the completed observation batch."""
        try:
            if self._gen is None:
                self._gen = self._plan()
                batch = next(self._gen)
            else:
                sent, self._obs = self._obs, []
                batch = self._gen.send(sent)
        except StopIteration:
            self._finished = True
            return
        self._queue = [c if isinstance(c, Candidate) else Candidate(int(c))
                       for c in batch]

    # -- legacy entry point ----------------------------------------------------
    def search(self, ev, max_steps: int) -> None:
        """Drive ``ev`` until the budget or the strategy is exhausted."""
        run_search(self, ev, max_steps)


def sequential_run_search(searcher: Searcher, ev, max_steps: int) -> None:
    """The original synchronous search loop, kept verbatim as the golden
    reference: ``run_search(..., in_flight=1)`` must replay it bit-for-bit
    (full trace, not just the best)."""
    start = ev.steps
    while ev.steps - start < max_steps and not ev.exhausted():
        cands = searcher.propose(max_steps - (ev.steps - start))
        if not cands:
            return
        searcher.observe(ev.measure_many(cands))


def run_search(searcher: Searcher, ev, max_steps: int,
               in_flight: int = 1,
               in_flight_max: Optional[int] = None) -> None:
    """The uniform event-driven ask-tell search loop used by every call site.

    Keeps up to ``in_flight`` candidates outstanding on the evaluator:
    while earlier submissions are still measuring, the searcher is asked for
    more (a generator-backed searcher that is waiting on its current batch
    simply returns ``[]`` and the loop collects instead).  With the
    default synchronous submit/collect shim and ``in_flight=1`` this is
    provably trace-identical to ``sequential_run_search``: the same
    candidates are proposed in the same order, evaluated one at a time, and
    recorded with identical (steps, elapsed, runtime) rows.

    ``in_flight_max`` makes the window ELASTIC: the loop reads the
    evaluator's backpressure (its ``workers`` lane count when it has one,
    plus the variance of observed measurement durations through an
    ``ElasticInFlight`` controller) and grows/shrinks the outstanding-work
    target between ``[in_flight, in_flight_max]`` — high duration variance
    deepens the queue so fast lanes never idle behind a straggler, uniform
    durations shrink it back to the lane count.  ``None`` (default) keeps
    the historical fixed-window behaviour, so existing call sites — and the
    ``in_flight=1`` golden equivalence — are unchanged.

    ``max_steps`` budgets *submissions* relative to the evaluator's state on
    entry (an evaluator that already spent steps on a training phase still
    gets a full search budget); everything submitted is drained before
    returning, so the account always ends with zero outstanding tests.
    """
    if in_flight < 1:
        raise ValueError(f"in_flight must be >= 1, got {in_flight}")
    ctrl = None
    if in_flight_max is not None:
        if in_flight_max < in_flight:
            raise ValueError(
                f"in_flight_max must be >= in_flight, got "
                f"{in_flight_max} < {in_flight}")
        from repro_torch.core.evaluate import ElasticInFlight

        ctrl = ElasticInFlight(lo=in_flight, hi=in_flight_max)
    limit = in_flight
    submitted = 0
    while True:
        while (submitted < max_steps and ev.outstanding() < limit
               and not ev.exhausted()):
            k = min(limit - ev.outstanding(), max_steps - submitted)
            cands = searcher.propose(k)
            if not cands:
                break   # searcher finished, or waiting on outstanding tests
            ev.submit(cands)
            submitted += len(cands)
        if ev.outstanding() == 0:
            return
        obs = ev.collect()
        if obs:
            searcher.observe(obs)
            if ctrl is not None:
                for o in obs:
                    ctrl.observe(o.runtime)
                limit = ctrl.target(getattr(ev, "workers", 1))


def resolve_searcher(searcher) -> Type[Searcher]:
    """Registry name (or class) -> searcher class."""
    if isinstance(searcher, str):
        if searcher not in SEARCHERS:
            raise KeyError(
                f"unknown searcher {searcher!r}; "
                f"registered: {sorted(SEARCHERS)}")
        return SEARCHERS[searcher]
    return searcher


def make_searcher(searcher, space: TuningSpace, seed: int = 0,
                  **context) -> Searcher:
    """Construct a searcher by registry name (or class), passing only the
    ``context`` kwargs its constructor accepts — so one call site can supply
    model/cores/... without special-casing which searcher wants what.

    The filtering is for shared context; explicit user options should be
    validated by the caller against ``resolve_searcher(...)``'s signature
    (``TuningSession.make_searcher`` does) so typos don't silently vanish.
    """
    import inspect

    cls = resolve_searcher(searcher)
    params = inspect.signature(cls.__init__).parameters
    accepted = {k: v for k, v in context.items() if k in params}
    return cls(space, seed=seed, **accepted)


@register_searcher("random")
class RandomSearcher(Searcher):
    """Uniform random search without replacement."""

    def __init__(self, space: TuningSpace, seed: int = 0):
        super().__init__(space, seed)

    def _plan(self):
        order = self.rng.permutation(len(self.space))
        yield [Candidate(int(i)) for i in order]


@register_searcher("warm_start")
class WarmStartSearcher(Searcher):
    """Walks the space in a caller-supplied predicted-best order.

    The order typically comes from a portable model's score/runtime ranking
    (e.g. the serving tuner ranks configs by TP→PC_ops predictions executed
    through the cost model), so a tight live budget — the paper's repeated-
    autotuning scenario (ii) — only spends empirical tests on the few most
    promising configurations.  Indices absent from ``order`` are appended in
    seed-shuffled order as a fallback tail, so an exhaustive budget still
    covers the space.
    """

    def __init__(self, space: TuningSpace, order: Optional[Sequence[int]] = None,
                 seed: int = 0):
        super().__init__(space, seed)
        self.order = [int(i) for i in (order if order is not None else [])]

    def _plan(self):
        seen = set(self.order)
        tail = [i for i in self.rng.permutation(len(self.space))
                if int(i) not in seen]
        yield [Candidate(int(i)) for i in list(self.order) + tail]


@register_searcher("transfer_warm_start")
class TransferredWarmStart(Searcher):
    """``WarmStartSearcher`` with a distrust-and-verify first wave, for
    orders that come from a model trained on a DIFFERENT tuning space.

    A transferred prior is a guess: the source model never saw this
    space, so its ranking may be anywhere between spot-on and misleading.
    The first wave hedges by spending ``verify`` trials on the prior's
    head AND ``verify`` random probes; if the prior's head beat the
    probes, the walk trusts the transferred order (probed indices
    excluded), otherwise it falls back to the seed-shuffled random walk a
    cold job would have run — so a bad transfer costs at most one wave,
    while a good one keeps the full warm-start benefit.
    """

    def __init__(self, space: TuningSpace,
                 order: Optional[Sequence[int]] = None,
                 seed: int = 0, verify: int = 4):
        super().__init__(space, seed)
        self.order = [int(i) for i in (order if order is not None else [])]
        self.verify = max(1, int(verify))
        self.trusted: Optional[bool] = None   # set after the first wave

    def _plan(self):
        perm = [int(i) for i in self.rng.permutation(len(self.space))]
        if not self.order:          # nothing transferred: plain random walk
            yield [Candidate(i) for i in perm]
            return
        k = min(self.verify, len(self.order))
        head = self.order[:k]
        head_set = set(head)
        probes = [i for i in perm if i not in head_set][:k]
        wave = head + probes
        obs = yield [Candidate(i) for i in wave]
        by_index = {o.index: o.runtime for o in obs}
        best_head = min(by_index.get(i, float("inf")) for i in head)
        best_probe = min((by_index.get(i, float("inf")) for i in probes),
                         default=float("inf"))
        self.trusted = best_head <= best_probe
        seen = set(wave)
        if self.trusted:
            rest = [i for i in self.order if i not in seen]
            seen.update(rest)
            tail = [i for i in perm if i not in seen]
            yield [Candidate(i) for i in rest + tail]
        else:
            yield [Candidate(i) for i in perm if i not in seen]


@register_searcher("profile")
class ProfileBasedSearcher(Searcher):
    """Algorithm 1: profile, detect bottlenecks, react, score, biased step.

    Parameters
    ----------
    model : TPPCModel — portable TP→PC_ops model (may come from a different
        GPU/input — §3.1/§4.4/§4.5 — or be an ExactCounterModel for §4.3).
        May be bound after construction (``searcher.model = m``) but must be
        set before the first ``propose``.
    cores : SM count of the *autotuning* hardware (bottleneck analysis
        runs on the architecture being tuned — §3.3).
    n : un-profiled benchmark runs between profiled runs (default 5, §3.7).
    inst_reaction : instruction-bottleneck threshold (0.7 default, §3.5.2).
    """

    def __init__(
        self,
        space: TuningSpace,
        model: Optional[TPPCModel] = None,
        cores: Optional[int] = None,
        n: int = 5,
        inst_reaction: float = reaction.INST_REACTION_DEFAULT,
        seed: int = 0,
    ):
        super().__init__(space, seed)
        self.model = model
        self.cores = cores
        self.n = n
        self.inst_reaction = inst_reaction
        # (matrix, name->column, PC_used mask) — built lazily (the model may
        # be bound after construction) and keyed on the model identity
        self._pred = None
        self._pred_model = None

    def _prediction(self):
        """The model's whole-space prediction matrix, computed once.

        Delegates to the module-level ``prediction_matrix`` cache, so the
        expensive part is shared across searcher instances (the experiment
        harness constructs one searcher per repetition); the per-search state
        here only re-derives the column index and PC_used mask.
        """
        if self._pred is None or self._pred_model is not self.model:
            names, matrix = prediction_matrix(self.model, self.space)
            cols = {name: j for j, name in enumerate(names)}
            self._pred = (matrix, cols, matrix != 0.0)
            self._pred_model = self.model
        return self._pred

    def _check_bound(self) -> None:
        """model and cores may be bound after construction (the registry's
        uniform signature) but must be set before searching — a silent
        default would mis-analyze bottlenecks, not error."""
        if self.model is None:
            raise ValueError(
                f"{type(self).__name__} needs a TP→PC model: pass model= at "
                "construction or assign searcher.model before searching")
        if self.cores is None:
            raise ValueError(
                f"{type(self).__name__} needs the tuning hardware's core "
                "count: pass cores= at construction or assign "
                "searcher.cores before searching")

    def _plan(self):
        self._check_bound()
        size = len(self.space)
        pred, cols, used = self._prediction()
        evaluated = np.zeros(size, dtype=bool)
        c_profile = int(self.rng.integers(size))
        while True:
            # line 3: empirical measurement with performance counters
            obs = yield [Candidate(c_profile, profile=True)]
            pc = obs[0].counters
            evaluated[c_profile] = True
            if pc is None:
                # the profiled test failed (crashing config marked
                # known-bad by a fault-tolerant caller): re-anchor on a
                # fresh unevaluated config instead of crashing the search
                remaining = np.flatnonzero(~evaluated)
                if remaining.size == 0:
                    return
                c_profile = int(remaining[self.rng.integers(remaining.size)])
                continue
            t = pc.runtime
            # line 4: bottleneck analysis (on the autotuning architecture)
            b = bottleneck.analyze(pc, cores=self.cores)
            # line 5: required counter changes
            delta_pc = reaction.compute_delta_pc(b, self.inst_reaction)
            # lines 6-14: score the whole space in one array pass (the
            # prediction matrix is fixed; only the ΔPC re-weighting changes
            # per profiling step)
            raw = scoring.score_space(delta_pc, pred[c_profile], pred, cols,
                                      used)
            raw[evaluated] = 0.0
            mask = ~evaluated
            if not mask.any():
                return
            weights = scoring.normalize_scores(raw)
            # lines 16-25: n biased un-profiled steps
            picks: List[Candidate] = []
            for _ in range(self.n):
                if not mask.any():
                    break
                sel = scoring.weighted_choice(weights, self.rng, mask)
                mask[sel] = False
                picks.append(Candidate(int(sel)))
            obs = yield picks
            for o in obs:
                evaluated[o.index] = True
                if o.runtime <= t:
                    c_profile, t = o.index, o.runtime


@register_searcher("basin_hopping")
class BasinHoppingSearcher(Searcher):
    """Kernel-Tuner-inspired Basin Hopping: greedy local descent over
    1-parameter neighbourhoods + random perturbation hops with Metropolis
    acceptance.  (Kernel Tuner wraps scipy.basinhopping over a normalized
    encoding; this is the discrete equivalent used for §4.7.)
    """

    def __init__(self, space: TuningSpace, seed: int = 0,
                 temperature: float = 1.0):
        super().__init__(space, seed)
        self.temperature = temperature
        self._known: Dict[int, float] = {}

    def _neighbours(self, idx: int) -> list:
        # the space's slot-hash index makes this O(degree) per query
        return self.space.neighbours(idx)

    def _measure_g(self, idx: int):
        """Sub-plan: measure ``idx`` once, replaying cached runtimes."""
        if idx not in self._known:
            obs = yield [Candidate(int(idx))]
            self._known[idx] = obs[0].runtime
        return self._known[idx]

    def _descent_g(self, start: int):
        """Sub-plan: first-improvement greedy descent from ``start``."""
        cur = start
        cur_t = yield from self._measure_g(cur)
        improved = True
        while improved:
            improved = False
            nbrs = [n for n in self._neighbours(cur) if n not in self._known]
            self.rng.shuffle(nbrs)
            for nb in nbrs:
                t = yield from self._measure_g(nb)
                if t < cur_t:
                    cur, cur_t = nb, t
                    improved = True
                    break  # first-improvement greedy
        return cur, cur_t

    def _perturb(self, idx: int) -> int:
        """Hop: randomly change a fraction of parameters, snap into space."""
        base = dict(self.space[idx])
        names = [p.name for p in self.space.parameters]
        k = max(1, len(names) // 3)
        for name in self.rng.choice(names, size=k, replace=False):
            p = next(q for q in self.space.parameters if q.name == name)
            base[name] = p.values[int(self.rng.integers(len(p.values)))]
        try:
            return self.space.index_of(base)
        except KeyError:  # violated a constraint — random fallback
            return int(self.rng.integers(len(self.space)))

    def _plan(self):
        cur = int(self.rng.integers(len(self.space)))
        cur, cur_t = yield from self._descent_g(cur)
        while True:
            cand = self._perturb(cur)
            if cand in self._known:
                unexplored = [i for i in range(len(self.space))
                              if i not in self._known]
                if not unexplored:
                    return
                cand = int(self.rng.choice(unexplored))
            cand, cand_t = yield from self._descent_g(cand)
            # Metropolis acceptance on the hop
            if cand_t < cur_t or self.rng.random() < np.exp(
                -(cand_t - cur_t) / (self.temperature * max(cur_t, 1e-12))
            ):
                cur, cur_t = cand, cand_t


@register_searcher("starchart")
class StarchartSearcher(Searcher):
    """Starchart protocol (§4.8.1): train a runtime regression tree from
    random samples until median relative prediction error < 15% (or 200
    training points), then walk the space in predicted-best order.

    Both training and validation measurements are empirical tests and are
    counted (the paper's "model build" column includes them).
    """

    def __init__(
        self,
        space: TuningSpace,
        seed: int = 0,
        n_validation: int = 200,
        max_train: int = 200,
        target_med_err: float = 0.15,
    ):
        super().__init__(space, seed)
        self.n_validation = n_validation
        self.max_train = max_train
        self.target_med_err = target_med_err
        self.model_build_steps = 0
        self._building = True

    def observe(self, observations) -> None:
        # every empirical test up to the end of model building counts as a
        # build step (the paper's "model build" column), even when the
        # budget truncates the build mid-batch
        super().observe(observations)
        if self._building:
            self.model_build_steps += len(observations)

    def _plan(self):
        size = len(self.space)
        X = self.space.feature_matrix
        order = self.rng.permutation(size)
        n_val = min(self.n_validation, max(1, size // 4))
        val_idx = order[:n_val]
        pool = order[n_val:]
        obs = yield [Candidate(int(i)) for i in val_idx]
        y_val = np.array([o.runtime for o in obs])

        train_idx: list = []
        y_train: list = []
        tree = None
        batch = 20
        cap = min(self.max_train, len(pool))
        while len(train_idx) < cap:
            take = pool[len(train_idx): len(train_idx) + batch]
            if take.size == 0:
                break
            obs = yield [Candidate(int(i)) for i in take]
            for o in obs:
                train_idx.append(o.index)
                y_train.append(o.runtime)
            tree = _build_tree(
                X[np.array(train_idx)], np.asarray(y_train), 0, 12, 1
            )
            pred = _tree_predict_batch(tree, X[val_idx])
            rel_err = np.abs(pred - y_val) / np.maximum(y_val, 1e-12)
            if float(np.median(rel_err)) < self.target_med_err:
                break
        self._building = False
        if tree is None:
            return
        # prediction-ordered walk over the unexplored space
        explored = set(int(i) for i in val_idx) | set(train_idx)
        pred_all = _tree_predict_batch(tree, X)
        walk = [Candidate(int(i)) for i in np.argsort(pred_all)
                if int(i) not in explored]
        if walk:
            yield walk


@register_searcher("profile_local")
class ProfileLocalSearcher(Searcher):
    """Beyond-paper extension (paper §3.9.1 future work): use the score as a
    GRADIENT ESTIMATE for a local searcher, combined with the global biased
    sampling to escape local optima.

    Each iteration profiles c_profile as in Algorithm 1, but the n unprofiled
    steps are split: the first are taken greedily from the best-scoring
    NEIGHBOURS of c_profile (1-parameter moves — following the estimated
    gradient of the performance function), the rest fall back to the global
    score-biased sample.  Mirrors Kernel Tuner's global+local findings [40]
    with the gradient supplied by the counter model instead of runtime
    probes.
    """

    def __init__(
        self,
        space: TuningSpace,
        model: Optional[TPPCModel] = None,
        cores: Optional[int] = None,
        n: int = 5,
        local_frac: float = 0.6,
        inst_reaction: float = reaction.INST_REACTION_DEFAULT,
        seed: int = 0,
    ):
        super().__init__(space, seed)
        self.model = model
        self.cores = cores
        self.n = n
        self.local_frac = local_frac
        self.inst_reaction = inst_reaction
        self._pred = None
        self._pred_model = None

    _check_bound = ProfileBasedSearcher._check_bound
    _prediction = ProfileBasedSearcher._prediction

    def _plan(self):
        self._check_bound()
        size = len(self.space)
        pred, cols, used = self._prediction()
        evaluated = np.zeros(size, dtype=bool)
        c_profile = int(self.rng.integers(size))
        while True:
            obs = yield [Candidate(c_profile, profile=True)]
            pc = obs[0].counters
            evaluated[c_profile] = True
            if pc is None:      # failed profile test: re-anchor, keep going
                remaining = np.flatnonzero(~evaluated)
                if remaining.size == 0:
                    return
                c_profile = int(remaining[self.rng.integers(remaining.size)])
                continue
            t = pc.runtime
            b = bottleneck.analyze(pc, cores=self.cores)
            delta_pc = reaction.compute_delta_pc(b, self.inst_reaction)

            raw = scoring.score_space(delta_pc, pred[c_profile], pred, cols,
                                      used)
            raw[evaluated] = 0.0
            mask = ~evaluated
            if not mask.any():
                return
            weights = scoring.normalize_scores(raw)

            n_local = int(round(self.n * self.local_frac))
            # local phase: best-scoring unexplored neighbours (gradient step)
            nbrs = [j for j in self.space.neighbours(c_profile)
                    if not evaluated[j]]
            nbrs.sort(key=lambda j: raw[j], reverse=True)
            local = nbrs[:n_local]
            for j in local:
                mask[j] = False
            if local:
                obs = yield [Candidate(int(j)) for j in local]
                for o in obs:
                    evaluated[o.index] = True
                    if o.runtime <= t:
                        c_profile, t = o.index, o.runtime
            # global phase: score-biased sampling (escape hatch)
            picks: List[Candidate] = []
            for _ in range(self.n - min(n_local, len(nbrs))):
                if not mask.any():
                    break
                sel = scoring.weighted_choice(weights, self.rng, mask)
                mask[sel] = False
                picks.append(Candidate(int(sel)))
            if picks:
                obs = yield picks
                for o in obs:
                    evaluated[o.index] = True
                    if o.runtime <= t:
                        c_profile, t = o.index, o.runtime
