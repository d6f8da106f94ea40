"""``repro_torch.tuning`` — the public ask-tell autotuning API.

* ``TuningSession`` — explicit ``train()`` / ``tune()`` phases, portable
  model artifacts (``save_model``/``load_model``).
* ``SEARCHERS`` — string-keyed registry of ask-tell searchers, all
  constructible as ``SEARCHERS[name](space, seed=s, ...)``; ``run_search``
  is the uniform search loop.
* ``Evaluator`` protocol + ``EvalAccount`` — shared
  measure/profile/measure_many accounting implemented by every evaluator
  (replay, cost model, the card, timed callables).
* ``model_to_dict``/``model_from_dict`` — JSON round-trip for trained
  TP→PC_ops models; ``from_jax_artifact`` carries one over from the JAX
  package.
"""
from repro_torch.core.account import (Candidate, EvalAccount, Evaluator,
                                      Observation, ProfilingUnsupported,
                                      Ticket)
from repro_torch.core.evaluate import (CostModelEvaluator,
                                       DeviceKernelEvaluator,
                                       FunctionEvaluator, RecordedSpace,
                                       ReplayEvaluator, VirtualAsyncEvaluator,
                                       record_space)
from repro_torch.core.searcher import (SEARCHERS, Searcher, make_searcher,
                                       register_searcher, resolve_searcher,
                                       run_search, sequential_run_search)
from repro_torch.core.tuner import (TuneResult, train_model,
                                    train_model_deliberate)
from repro_torch.tuning.serialize import (from_jax_artifact, model_from_dict,
                                          model_to_dict, space_from_dict,
                                          space_to_dict)
from repro_torch.tuning.session import TuningSession

__all__ = [
    "Candidate", "CostModelEvaluator", "DeviceKernelEvaluator",
    "EvalAccount", "Evaluator", "FunctionEvaluator", "Observation",
    "ProfilingUnsupported", "RecordedSpace", "ReplayEvaluator", "SEARCHERS",
    "Searcher", "Ticket", "TuneResult", "TuningSession",
    "VirtualAsyncEvaluator", "from_jax_artifact", "make_searcher",
    "model_from_dict", "model_to_dict", "record_space", "register_searcher",
    "resolve_searcher", "run_search", "sequential_run_search",
    "space_from_dict", "space_to_dict", "train_model",
    "train_model_deliberate",
]
