"""A model trained by the JAX package, carried across with
``from_jax_artifact``, predicts identically in the port and steers an
identical search."""
import json

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import hwspec as jhw
from repro.kernels.matmul import space as jspace
from repro.tuning import TuningSession as JSession
from repro_torch.core import counters as PC
from repro_torch.core.evaluate import CostModelEvaluator
from repro_torch.kernels.matmul import space as pspace
from repro_torch.tuning import TuningSession as PSession
from repro_torch.tuning import from_jax_artifact, model_from_dict
from test_torch_space_costmodel import port_spec


def _sessions(kind, tmp_path):
    js = JSession(jspace.make_space(),
                  lambda c: jspace.workload_fn(c, jspace.DEFAULT_INPUT),
                  hw=jhw.TPU_V5E, seed=1)
    js.train(train_hw=jhw.TPU_V4, kind=kind)
    jpath = tmp_path / "jax_model.json"
    js.save_model(str(jpath))
    ppath = tmp_path / "port_model.json"
    ppath.write_text(json.dumps(from_jax_artifact(json.loads(jpath.read_text()))))
    pwl = lambda c: pspace.workload_fn(c, pspace.DEFAULT_INPUT)  # noqa: E731
    phw = port_spec(jhw.TPU_V5E)
    ps = PSession(pspace.make_space(), pwl, hw=phw, seed=1,
                  evaluator_factory=lambda sp: CostModelEvaluator(sp, pwl, phw))
    ps.load_model(str(ppath))
    return js, ps


@pytest.mark.parametrize("kind", ["tree", "quadratic", "exact"])
def test_carried_model_predicts_identically(kind, tmp_path):
    js, ps = _sessions(kind, tmp_path)
    jnames, jmat = js.prediction_matrix()
    pnames, pmat = ps.prediction_matrix()
    assert [PC.TPU_NAMES[n] for n in pnames] == list(jnames)
    assert np.array_equal(pmat, jmat)


@pytest.mark.parametrize("searcher", ["profile", "profile_local"])
def test_carried_model_steers_an_identical_tune(searcher, tmp_path):
    js, ps = _sessions("tree", tmp_path)
    jr = js.tune(budget=25, searcher=searcher)
    pr = ps.tune(budget=25, searcher=searcher)
    assert pr.history == jr.history
    assert pr.best_config == jr.best_config


def test_port_refuses_an_unconverted_jax_artifact(tmp_path):
    js, _ = _sessions("tree", tmp_path)
    raw = json.loads((tmp_path / "jax_model.json").read_text())
    assert "signature" in raw
    with pytest.raises(ValueError, match="format"):
        model_from_dict(raw)
    converted = from_jax_artifact(raw)
    assert "signature" not in converted
    assert set(converted["trees"]) <= set(PC.PC_OPS)
    with pytest.raises(ValueError, match="format"):
        from_jax_artifact(converted)


def test_unknown_counter_names_are_refused(tmp_path):
    js, _ = _sessions("tree", tmp_path)
    raw = json.loads((tmp_path / "jax_model.json").read_text())
    raw["trees"]["NOT_A_COUNTER"] = raw["trees"]["HBM_RD"]
    with pytest.raises(KeyError, match="NOT_A_COUNTER"):
        from_jax_artifact(raw)


def test_port_artifact_round_trips(tmp_path):
    _, ps = _sessions("quadratic", tmp_path)
    path = tmp_path / "again.json"
    ps.save_model(str(path))
    again = PSession(pspace.make_space(), hw=port_spec(jhw.TPU_V5E))
    again.load_model(str(path))
    assert np.array_equal(again.prediction_matrix()[1],
                          ps.prediction_matrix()[1])
