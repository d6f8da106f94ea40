"""Core: the paper's contribution — profile-counter-guided tuning-space search.

Public API:
    TuningParameter, TuningSpace          — generic tuning spaces
    CounterSet, PC_OPS, PC_STRESS         — Hopper counter taxonomy
    HardwareSpec, SPECS, detect           — H100 specs
    analyze / compute_delta_pc            — expert system
    DecisionTreeModel / QuadraticRegressionModel / ExactCounterModel
    ProfileBasedSearcher (+ baselines)    — Algorithm 1
    DeviceKernelEvaluator                 — launch and time on the card
    autotune / train_model / run_search_experiment
"""
from repro_torch.core.account import (AccountSnapshot, Candidate,
                                      EvalAccount, Evaluator, Observation,
                                      ProfilingUnsupported, Ticket)
from repro_torch.core.bottleneck import analyze
from repro_torch.core.counters import (PC_OPS, PC_STRESS, TPU_NAMES,
                                       CounterSet)
from repro_torch.core.evaluate import (CostModelEvaluator,
                                       DeviceKernelEvaluator,
                                       FunctionEvaluator, RecordedSpace,
                                       ReplayEvaluator, VirtualAsyncEvaluator,
                                       record_space)
from repro_torch.core.hwspec import SPECS, HardwareSpec, detect
from repro_torch.core.model import (DecisionTreeModel, ExactCounterModel,
                                    QuadraticRegressionModel,
                                    deliberate_training_sample,
                                    prediction_matrix)
from repro_torch.core.reaction import compute_delta_pc
from repro_torch.core.searcher import (SEARCHERS, BasinHoppingSearcher,
                                       ProfileBasedSearcher,
                                       ProfileLocalSearcher, RandomSearcher,
                                       Searcher, StarchartSearcher,
                                       WarmStartSearcher, make_searcher,
                                       register_searcher, resolve_searcher,
                                       run_search, sequential_run_search)
from repro_torch.core.tuner import (SearchStats, TuneResult, autotune,
                                    convergence_curve, predicted_runtimes,
                                    run_search_experiment,
                                    steps_to_well_performing, train_model,
                                    train_model_deliberate)
from repro_torch.core.tuning_space import (Config, TuningParameter,
                                           TuningSpace, powers_of_two)

__all__ = [
    "analyze", "autotune", "compute_delta_pc", "convergence_curve", "detect",
    "make_searcher", "record_space", "register_searcher", "resolve_searcher",
    "run_search", "sequential_run_search",
    "run_search_experiment", "steps_to_well_performing",
    "train_model", "train_model_deliberate", "deliberate_training_sample",
    "powers_of_two", "predicted_runtimes", "prediction_matrix",
    "AccountSnapshot", "BasinHoppingSearcher", "Candidate", "Config",
    "CostModelEvaluator", "CounterSet", "DecisionTreeModel",
    "DeviceKernelEvaluator", "EvalAccount", "Evaluator",
    "ExactCounterModel", "FunctionEvaluator", "HardwareSpec", "Observation",
    "PC_OPS", "PC_STRESS", "ProfileBasedSearcher", "ProfileLocalSearcher",
    "ProfilingUnsupported", "QuadraticRegressionModel", "RandomSearcher",
    "RecordedSpace", "ReplayEvaluator", "SEARCHERS", "SPECS", "SearchStats",
    "Searcher", "StarchartSearcher", "TPU_NAMES", "Ticket", "TuneResult",
    "TuningParameter", "TuningSpace", "VirtualAsyncEvaluator",
    "WarmStartSearcher",
]
