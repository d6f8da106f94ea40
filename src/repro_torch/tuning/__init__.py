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
* ``ConfigStore`` — persistent JSON store of tuned configs + model artifacts
  keyed by (problem kind, space name, input-shape bucket, hardware), with
  the cross-space transfer tier: ``SpaceSignature``/``similarity`` find a
  structurally similar space's model, ``rebind_model_dict`` rebinds it.
* ``TuningProblem`` — the tuner-facing problem contract and its string
  registry (``make_problem("kernel", "conv2d/4096")``).
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
from repro_torch.tuning.serialize import (artifact_signature,
                                          ensure_signature, from_jax_artifact,
                                          model_from_dict, model_to_dict,
                                          rebind_model_dict, space_from_dict,
                                          space_to_dict)
from repro_torch.tuning.signature import (DEFAULT_TRANSFER_THRESHOLD,
                                          ParamSlot, SpaceSignature,
                                          map_parameters, similarity,
                                          transfer_compatible)
from repro_torch.tuning.problem import (KernelProblem, TuningProblem,
                                        list_problems, make_problem,
                                        parse_problem, problem_kinds,
                                        register_problem_kind)
from repro_torch.tuning.session import TuningSession
from repro_torch.tuning.store import (ConfigStore, StoreEntry, legacy_kind,
                                      split_key, store_key)

__all__ = [
    "Candidate", "ConfigStore", "CostModelEvaluator",
    "DEFAULT_TRANSFER_THRESHOLD", "DeviceKernelEvaluator", "EvalAccount",
    "Evaluator", "FunctionEvaluator", "KernelProblem", "Observation",
    "ParamSlot", "ProfilingUnsupported", "RecordedSpace", "ReplayEvaluator",
    "SEARCHERS", "Searcher", "SpaceSignature", "StoreEntry", "Ticket",
    "TuneResult", "TuningProblem", "TuningSession", "VirtualAsyncEvaluator",
    "artifact_signature", "ensure_signature", "from_jax_artifact",
    "legacy_kind", "list_problems", "make_problem", "make_searcher",
    "map_parameters", "model_from_dict", "model_to_dict", "parse_problem",
    "problem_kinds", "rebind_model_dict", "record_space",
    "register_problem_kind", "register_searcher", "resolve_searcher",
    "run_search", "sequential_run_search", "similarity", "split_key",
    "space_from_dict", "space_to_dict", "store_key", "train_model",
    "train_model_deliberate", "transfer_compatible",
]
