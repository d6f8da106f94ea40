"""JSON round-trip for trained TP→PC_ops models — the portability artifact.

The paper's headline claim is that a model trained on one GPU/input steers
autotuning on another.  ``model_to_dict``/``model_from_dict`` turn that
claim into a shippable file: train anywhere, ``TuningSession.save_model``,
copy the JSON to the machine of interest, ``load_model`` and tune.
``from_jax_artifact`` carries a model trained by the JAX package across.

Serialized alongside the model are the tuning-space *parameters* (names and
value lists) — everything the models need to vectorize configurations.
Space constraints are predicates and are NOT serialized; tree/quadratic
models never consult space indexing, and exact models carry their own
explicit (config, counters) pairs, so reconstruction is faithful either way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.counters import FROM_TPU_NAMES
from repro_torch.core.model import (DecisionTreeModel, ExactCounterModel,
                                    QuadraticRegressionModel, TPPCModel,
                                    _Node)
from repro_torch.core.tuning_space import TuningParameter, TuningSpace

# The port's own format name: an artifact of the JAX package names TPU
# counters and must go through ``from_jax_artifact`` first.
FORMAT = "repro_torch.tppc_model"
JAX_FORMAT = "repro.tppc_model"
VERSION = 1


# -- tuning space (parameters only) -------------------------------------------
def space_to_dict(space: TuningSpace) -> Dict:
    return {
        "name": space.name,
        "parameters": [
            {"name": p.name, "values": list(p.values)}
            for p in space.parameters
        ],
    }


def space_from_dict(d: Dict) -> TuningSpace:
    return TuningSpace(
        [TuningParameter(p["name"], tuple(p["values"]))
         for p in d["parameters"]],
        name=d.get("name", "space"),
    )


# -- decision trees ------------------------------------------------------------
def _node_to_dict(n: _Node) -> Dict:
    if n.is_leaf:
        return {"value": n.value}
    return {
        "value": n.value,
        "feature": n.feature,
        "threshold": n.threshold,
        "left": _node_to_dict(n.left),
        "right": _node_to_dict(n.right),
    }


def _node_from_dict(d: Dict) -> _Node:
    node = _Node(value=float(d["value"]))
    if "feature" in d:
        node.feature = int(d["feature"])
        node.threshold = float(d["threshold"])
        node.left = _node_from_dict(d["left"])
        node.right = _node_from_dict(d["right"])
    return node


def _check_space_compatible(space: TuningSpace, space_dict: Dict) -> None:
    """Models vectorize configs by the bound space's parameter order and
    value lists — a mismatch would silently mispredict, so refuse it."""
    ours = [(p.name, list(p.values)) for p in space.parameters]
    theirs = [(p["name"], list(p["values"])) for p in space_dict["parameters"]]
    if ours != theirs:
        raise ValueError(
            "model artifact was trained on an incompatible tuning space: "
            f"artifact parameters {theirs} vs target space {ours}")


# -- model <-> dict ------------------------------------------------------------
def model_to_dict(model: TPPCModel,
                  space: Optional[TuningSpace] = None) -> Dict:
    """Serialize a trained model (plus its space's parameters) to JSON-safe
    primitives.  ``space`` defaults to the model's own space."""
    space = space if space is not None else model.space
    out = {"format": FORMAT, "version": VERSION,
           "space": space_to_dict(space)}
    if isinstance(model, DecisionTreeModel):
        out["kind"] = "tree"
        out["trees"] = {name: _node_to_dict(t)
                        for name, t in model.trees.items()}
        out["scale"] = {name: float(s) for name, s in model.scale.items()}
    elif isinstance(model, QuadraticRegressionModel):
        out["kind"] = "quadratic"
        out["counter_names"] = list(model.counter_names)
        out["coefs"] = {
            ",".join(str(int(b)) for b in key): {
                name: [float(x) for x in coef]
                for name, coef in per_counter.items()
            }
            for key, per_counter in model.coefs.items()
        }
        out["fallback"] = {name: float(v)
                           for name, v in model._fallback.items()}
    elif isinstance(model, ExactCounterModel):
        out["kind"] = "exact"
        # pair configs and counters from the same enumeration: the bound
        # space's.  ``predict_index`` routes through the space→record remap,
        # so re-serializing a ``from_pairs`` model whose space enumerates
        # differently from the original artifact stays aligned (writing the
        # raw record list here would silently shuffle the pairs).
        out["configs"] = [model.space[i] for i in range(len(model.space))]
        out["counters"] = [
            {name: float(v) for name, v in model.predict_index(i).items()}
            for i in range(len(model.space))
        ]
    else:
        raise TypeError(f"cannot serialize model type {type(model).__name__}")
    return out


def model_from_dict(d: Dict, space: Optional[TuningSpace] = None) -> TPPCModel:
    """Reconstruct a trained model.  Pass ``space`` to bind the model to an
    existing (possibly constraint-pruned) space; otherwise the parameters
    recorded in the artifact are used to rebuild one."""
    if d.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: format={d.get('format')!r}")
    if d.get("version") != VERSION:
        raise ValueError(f"unsupported {FORMAT} version {d.get('version')!r}")
    if space is not None:
        _check_space_compatible(space, d["space"])
    else:
        space = space_from_dict(d["space"])
    kind = d["kind"]
    if kind == "tree":
        trees = {name: _node_from_dict(t) for name, t in d["trees"].items()}
        scale = {name: float(s) for name, s in d["scale"].items()}
        model: TPPCModel = DecisionTreeModel.from_state(space, trees, scale)
    elif kind == "quadratic":
        coefs = {
            tuple(int(b) for b in key.split(",") if b != ""): {
                name: np.asarray(coef, dtype=np.float64)
                for name, coef in per_counter.items()
            }
            for key, per_counter in d["coefs"].items()
        }
        model = QuadraticRegressionModel.from_state(
            space, d["counter_names"], coefs, d["fallback"])
    elif kind == "exact":
        model = ExactCounterModel.from_pairs(space, d["configs"], d["counters"])
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    return model


# -- carrying a model across from the JAX package -----------------------------
def _rename(names: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for tpu_name, v in names.items():
        if tpu_name not in FROM_TPU_NAMES:
            raise KeyError(f"JAX artifact names counter {tpu_name!r}, which "
                           "has no Hopper counterpart")
        out[FROM_TPU_NAMES[tpu_name]] = v
    return out


def from_jax_artifact(d: Dict) -> Dict:
    """Convert the JSON dict ``repro.tuning.TuningSession.save_model``
    writes into this package's artifact: every counter renamed through
    ``counters.TPU_NAMES`` and the structural signature dropped.  Loading
    the result predicts what the JAX model predicts, counter for counter."""
    if d.get("format") != JAX_FORMAT:
        raise ValueError(f"not a {JAX_FORMAT} artifact: "
                         f"format={d.get('format')!r}")
    if d.get("version") != VERSION:
        raise ValueError(f"unsupported {JAX_FORMAT} version "
                         f"{d.get('version')!r}")
    out = {k: v for k, v in d.items() if k != "signature"}
    out["format"] = FORMAT
    kind = d["kind"]
    if kind == "tree":
        out["trees"] = _rename(d["trees"])
        out["scale"] = _rename(d["scale"])
    elif kind == "quadratic":
        out["counter_names"] = list(_rename(
            {n: None for n in d["counter_names"]}))
        out["coefs"] = {key: _rename(per) for key, per in d["coefs"].items()}
        out["fallback"] = _rename(d["fallback"])
    elif kind == "exact":
        out["counters"] = [_rename(rec) for rec in d["counters"]]
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    return out
