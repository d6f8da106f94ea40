"""``TuningSession`` — the paper's two-phase workflow as one object.

Phase 1 (``train`` / ``train_on_evaluator``): build a portable TP→PC_ops
model from a tuning space recorded on ANY hardware/input.  The trained model
is an artifact: ``save_model``/``load_model`` round-trip it through JSON so a
model trained on one GPU or input ships to another.

Phase 2 (``tune``): counter-guided (or baseline) search on the
hardware/input of interest, through any evaluator implementing the shared
protocol, driven in ask-tell form.  ``tune`` measures with the evaluator
it is given, or else the one ``evaluator_factory`` builds; there is no
default, so a session never prices configurations with the cost model
unless its caller asks for that.  On the card the factory builds a
``DeviceKernelEvaluator``:

    bench = BENCHMARKS["matmul"]
    inp = bench.inputs["2048"]
    session = TuningSession(
        bench.make_space(), lambda c: bench.workload_fn(c, inp),
        hw=hwspec.detect(),
        evaluator_factory=lambda space: DeviceKernelEvaluator(space, bench,
                                                              inp))
    session.load_model("gemm_tppc.json")           # or train_on_evaluator
    result = session.tune(budget=25)               # ProfileBasedSearcher
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.core.account import Evaluator
from repro_torch.core.evaluate import record_space
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.core.model import (DecisionTreeModel, TPPCModel,
                                    deliberate_training_sample)
from repro_torch.core.searcher import Searcher, make_searcher, run_search
from repro_torch.core.tuner import (TuneResult, train_model,
                                    train_model_deliberate)
from repro_torch.core.tuning_space import Config, TuningSpace
from repro_torch.tuning.serialize import model_from_dict, model_to_dict


class TuningSession:
    """Explicit train/tune phases over one tuning space.

    Parameters
    ----------
    space : the tuning space (what to search).
    workload_fn : portable workload model ``g(TP) -> PC_ops`` — needed for
        the cost-model evaluator and for ``train()``; optional when a custom
        evaluator and a pre-trained/loaded model are supplied instead.
    hw : the hardware OF INTEREST (autotuning target).  Optional when every
        ``tune()`` call passes its own evaluator.
    model : a pre-trained TP→PC_ops model (skips the training phase).
    seed : default RNG seed for training sampling and searchers.
    evaluator_factory : ``space -> Evaluator`` used by ``tune()`` when no
        evaluator is passed.  Without it, ``tune()`` needs ``evaluator=``.
        The cost model is one choice among others:
        ``lambda sp: CostModelEvaluator(sp, workload_fn, hw)``.
    """

    def __init__(
        self,
        space: TuningSpace,
        workload_fn: Optional[Callable[[Config], Dict[str, float]]] = None,
        hw: Optional[HardwareSpec] = None,
        *,
        model: Optional[TPPCModel] = None,
        seed: int = 0,
        evaluator_factory: Optional[
            Callable[[TuningSpace], Evaluator]] = None,
    ):
        self.space = space
        self.evaluator_factory = evaluator_factory
        self.workload_fn = workload_fn
        self.hw = hw
        self.model = model
        self.seed = seed
        self.train_record = None
        self.result: Optional[TuneResult] = None

    # =========================================================================
    # Phase 1 — training (anywhere)
    # =========================================================================
    def train(
        self,
        train_hw: Optional[HardwareSpec] = None,
        kind: str = "tree",
        sample: Union[str, Sequence[int]] = "deliberate",
        seed: Optional[int] = None,
    ) -> TPPCModel:
        """Record the space on ``train_hw`` (default: the target hardware)
        and fit a TP→PC_ops model.

        ``sample``: 'deliberate' (§3.4.1 2-3-values-per-parameter), 'full'
        (exhaustive), or an explicit sequence of config indices.
        """
        if self.workload_fn is None:
            raise ValueError("train() needs workload_fn; use "
                             "train_on_evaluator() or load_model() instead")
        hw = train_hw if train_hw is not None else self.hw
        if hw is None:
            raise ValueError("train() needs train_hw or a session hw")
        seed = self.seed if seed is None else seed
        rec = record_space(self.space, self.workload_fn, hw)
        if isinstance(sample, str):
            if sample == "deliberate":
                self.model = train_model_deliberate(rec, kind=kind, seed=seed)
            elif sample == "full":
                self.model = train_model(rec, kind=kind, seed=seed)
            else:
                raise ValueError(f"unknown sample strategy {sample!r}")
        else:
            self.model = train_model(rec, kind=kind, sample=sample, seed=seed)
        self.train_record = rec
        return self.model

    def train_on_evaluator(
        self,
        evaluator: Evaluator,
        sample: Optional[Sequence[int]] = None,
        values_per_param: int = 2,
        max_samples: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> TPPCModel:
        """Training phase against a live evaluator (e.g. the card):
        profile a deliberate sample of its space and fit a decision tree.

        The profiled tests are charged to ``evaluator``'s account — in the
        expensive-measurement regime they are real empirical tests.
        """
        seed = self.seed if seed is None else seed
        idxs = list(sample) if sample is not None else \
            deliberate_training_sample(
                evaluator.space, values_per_param=values_per_param,
                rng=np.random.default_rng(seed))
        if max_samples is not None:
            idxs = idxs[:max_samples]
        cfgs, counters = [], []
        for i in idxs:
            cs = evaluator.profile(i)
            cfgs.append(evaluator.space[i])
            counters.append(cs.ops)
        self.model = DecisionTreeModel(evaluator.space, cfgs, counters,
                                       rng=np.random.default_rng(seed))
        return self.model

    # =========================================================================
    # The artifact — portable models
    # =========================================================================
    def save_model(self, path: str) -> str:
        """Write the trained model (+ space parameters) to JSON."""
        if self.model is None:
            raise ValueError("no trained model to save; call train() first")
        with open(path, "w") as f:
            json.dump(model_to_dict(self.model, self.space), f)
        return path

    def load_model(self, path: str) -> TPPCModel:
        """Load a model artifact, binding it to this session's space."""
        with open(path) as f:
            self.model = model_from_dict(json.load(f), space=self.space)
        return self.model

    def save_model_to_store(self, store, bucket: str,
                            hardware: Optional[str] = None,
                            kind: Optional[str] = None) -> None:
        """Publish the trained model into a ``ConfigStore`` under
        ``(kind, space name, bucket, hardware)`` — the persistent analog
        of ``save_model`` for online/serving tuners.  ``hardware``
        defaults to the session's target hardware name; ``kind`` is the
        problem-kind namespace (default: inferred from the space name)."""
        if self.model is None:
            raise ValueError("no trained model to save; call train() first")
        hw = hardware if hardware is not None else (
            self.hw.name if self.hw is not None else "any")
        store.save_model(self.space.name, bucket, hw, self.model, self.space,
                         kind=kind)

    def load_model_from_store(self, store, bucket: str,
                              hardware: Optional[str] = None,
                              kind: Optional[str] = None
                              ) -> Optional[TPPCModel]:
        """Bind a stored model artifact to this session (None on miss)."""
        hw = hardware if hardware is not None else (
            self.hw.name if self.hw is not None else "any")
        model = store.load_model(self.space.name, bucket, hw,
                                 bind_space=self.space, kind=kind)
        if model is not None:
            self.model = model
        return model

    def prediction_matrix(self):
        """(counter_names, n_configs × n_counters) predictions of the
        session's model over its space — the array the profile searchers
        score against, shared/memoized per (model, space).  Useful for
        inspecting what the portable model believes about the space without
        running a search."""
        if self.model is None:
            raise ValueError("no model; call train() or load_model() first")
        from repro_torch.core.model import prediction_matrix

        return prediction_matrix(self.model, self.space)

    # =========================================================================
    # Phase 2 — autotuning (on the hardware/input of interest)
    # =========================================================================
    def make_evaluator(self) -> Evaluator:
        """The evaluator ``evaluator_factory`` builds for the session's
        space; raises when the session was given no factory."""
        if self.evaluator_factory is None:
            raise ValueError(
                "session has no evaluator_factory; pass one to the session "
                "(e.g. a DeviceKernelEvaluator on the card) or pass "
                "evaluator= to tune()")
        return self.evaluator_factory(self.space)

    def make_searcher(self, searcher: Union[str, type, Searcher] = "profile",
                      seed: Optional[int] = None, **kwargs) -> Searcher:
        """Instantiate a searcher bound to this session's model/hardware.

        The session's model and SM count are passed implicitly (cores
        falls back to 1 when the session has no hw).  Explicit ``kwargs``
        are validated against the searcher's constructor so typos raise
        instead of vanishing.
        """
        if isinstance(searcher, Searcher):
            if kwargs or seed is not None:
                raise TypeError(
                    "searcher options/seed cannot be applied to an "
                    "already-constructed searcher instance")
            return searcher
        import inspect

        from repro_torch.core.searcher import resolve_searcher

        cls = resolve_searcher(searcher)
        params = inspect.signature(cls.__init__).parameters
        unknown = sorted(k for k in kwargs if k not in params)
        if unknown:
            options = sorted(set(params) - {"self", "space", "seed"})
            raise TypeError(
                f"{cls.__name__} does not accept {unknown}; "
                f"its options are {options}")
        context = dict(model=self.model,
                       cores=self.hw.sms if self.hw is not None else 1)
        context.update(kwargs)
        return make_searcher(cls, self.space,
                             seed=self.seed if seed is None else seed,
                             **context)

    def tune(
        self,
        budget: int = 60,
        searcher: Union[str, type, Searcher] = "profile",
        evaluator: Optional[Evaluator] = None,
        seed: Optional[int] = None,
        in_flight: int = 1,
        **searcher_kwargs,
    ) -> TuneResult:
        """Run the autotuning phase: ask-tell search under a step budget.

        ``in_flight`` > 1 keeps that many empirical tests outstanding on the
        evaluator (meaningful with async backends — the default synchronous
        shim still evaluates serially, and ``in_flight=1`` replays the
        sequential search loop exactly).
        """
        ev = evaluator if evaluator is not None else self.make_evaluator()
        s = self.make_searcher(searcher, seed=seed, **searcher_kwargs)
        run_search(s, ev, budget, in_flight=in_flight)
        if ev.best_index is None:
            raise RuntimeError("search made no empirical tests "
                               "(budget <= 0 or empty space?)")
        per_config: Dict[int, float] = {}
        for idx, rt in ev.history():
            per_config.setdefault(idx, rt)
        self.result = TuneResult(
            best_config=ev.space[ev.best_index],
            best_runtime=ev.best_runtime,
            steps=ev.steps,
            history=sorted(per_config.items()),
        )
        return self.result
