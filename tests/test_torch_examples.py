"""The port's five examples (``examples/torch_*.py``) against the JAX
package's (``examples/*.py``), on the CPU.

* quickstart: with the JAX package's TPU specs registered in the port
  under their names (``tpu_names``), training on ``tpu_v4`` and tuning on
  ``tpu_v5e`` gives the JAX flow's best configuration and test count, its
  best runtime to 1e-12; the 256³ check (the kernel's plain version)
  meets ``repro``'s oracle at 2e-4.
* serve_autotune: under the same specs, every tick's bucket, live
  trials, reuse and configuration equal the JAX example's tuner's, both
  runs; run 2 spends 0 live trials.
* serve_batch: the SMOKE qwen2.5-3b (fp32) with the JAX example's weights
  carried across (``models.convert``) gives every request the JAX
  example's greedy tokens.
* train_lm: ``--smoke --device cpu --steps 2 --ckpt-every 1`` exits 0, and
  the JAX checkpointer restores the last step it wrote, leaf for leaf the
  port's.
* autotune_train_step: on a SMOKE arch at ``--budget 1 --train-samples
  1`` it writes the JAX example's keys.
* Without a card, each example that needs one raises unless ``--device
  cpu`` is given.
"""
import ast
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_service_sides import tpu_names  # noqa: F401  (fixture)
from repro.configs import SMOKES as JSMOKES
from repro.core import SPECS as JSPECS
from repro.kernels.matmul.space import GemmInput as JGemmInput
from repro.kernels.registry import BENCHMARKS as JBENCHMARKS
from repro.models.registry import build_model as jbuild
from repro.tuning import TuningSession as JSession
from repro_torch.configs import SMOKES
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
GEMM_TOL = 2e-4


def _example(name):
    """``examples/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_tunes_as_the_jax_flow_and_meets_its_oracle(
        tpu_names, tmp_path):
    got = _example("torch_quickstart").run(
        train_hw="tpu_v4", hw="tpu_v5e", device="cpu",
        artifact=str(tmp_path / "gemm.json"), say=lambda *_: None)
    # the JAX example's flow (examples/quickstart.py)
    bm = JBENCHMARKS["matmul"]
    space = bm.make_space()
    workload = lambda cfg: bm.workload_fn(cfg, bm.default_input)  # noqa
    trainer = JSession(space, workload, hw=JSPECS["tpu_v4"], seed=0)
    trainer.train(kind="tree")
    trainer.save_model(str(tmp_path / "jax.json"))
    session = JSession(space, workload, hw=JSPECS["tpu_v5e"], seed=0)
    session.load_model(str(tmp_path / "jax.json"))
    want = session.tune(budget=25)
    assert got["best_config"] == dict(want.best_config)
    assert got["steps"] == want.steps == 25 and got["space"] == len(space)
    assert got["best_runtime"] == pytest.approx(want.best_runtime,
                                                rel=1e-12)
    a, b = bm.make_args(JGemmInput(256, 256, 256), np.random.default_rng(0))
    ref = np.asarray(bm.ref(a, b))
    err = np.max(np.abs(got["check_out"] - ref)) / np.max(np.abs(ref))
    assert err <= GEMM_TOL and got["rel_err"] <= GEMM_TOL
    assert got["launches"] == 0          # the plain version on the CPU


def _ticks(reports):
    return [(r.bucket, r.live_trials, r.reused, dict(r.config))
            for r in reports]


def test_serve_autotune_ticks_equal_the_jax_examples(tpu_names, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jex = _example("serve_autotune")
    store = str(tmp_path / "jax" / "serve_store.json")
    want = [_ticks(jex.run(store).reports), _ticks(jex.run(store).reports)]
    got = _example("torch_serve_autotune").run(
        store_dir=str(tmp_path / "port"), hw="tpu_v4", train_hw="tpu_v5e",
        say=lambda *_: None)
    assert [_ticks(r) for r in got["runs"]] == want
    assert got["run2_live_trials"] == 0
    assert sum(t[1] for t in want[0]) > 0   # run 1 tuned live


def test_serve_batch_gives_the_jax_examples_tokens(capsys):
    _example("serve_batch").main()
    printed = capsys.readouterr().out
    want = {int(m.group(1)): ast.literal_eval(m.group(2)) for m in
            re.finditer(r"^request (\d+): (\[.*\])$", printed, re.M)}
    assert len(want) == 10
    arch = "qwen2.5-3b"
    params = params_from_jax(SMOKES[arch], jax.tree.map(
        np.asarray, jbuild(JSMOKES[arch]).init(jax.random.PRNGKey(0))))
    got = _example("torch_serve_batch").run(
        smoke=True, device="cpu", params=params, say=lambda *_: None)
    assert got["tokens"] == want
    assert got["n_tokens"] == 80 and got["attention_launches"] == 0


def test_train_lm_writes_a_checkpoint_the_jax_checkpointer_reads(tmp_path):
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.checkpoint.checkpointer import _flatten
    from repro.optim import adamw as JO
    from repro.train.train_step import init_train_state as jinit
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     state_arrays)
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as PO
    from repro_torch.train.train_step import init_train_state

    ckpt = tmp_path / "ckpt"
    with pytest.raises(SystemExit) as done:
        _example("torch_train_lm").main(
            ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every",
             "1", "--ckpt-dir", str(ckpt)])
    assert done.value.code == 0
    arch = "qwen1.5-0.5b"
    jstate = jinit(jbuild(JSMOKES[arch]), JO.AdamW(lr=JO.constant_lr(1e-3)),
                   jax.random.PRNGKey(1))
    restored = JCheckpointer(str(ckpt)).restore(2, jstate)
    assert int(restored.step) == 2 and int(restored.opt.count) == 2
    step, state = Checkpointer(str(ckpt)).restore_latest(init_train_state(
        build_model(SMOKES[arch]), PO.AdamW(lr=PO.constant_lr(1e-3)),
        torch.Generator().manual_seed(5), "cpu"))
    assert step == 2
    want = state_arrays(state)
    got = {k: np.asarray(v) for k, v in _flatten(restored)}
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# the keys examples/autotune_train_step.py writes to --out
STEP_TUNE_KEYS = {"space", "train_samples", "budget", "profile", "random",
                  "train_best_ms", "train_best_config", "total_seconds"}


def test_autotune_train_step_writes_the_jax_examples_keys(tmp_path):
    out = tmp_path / "step_tune.json"
    _example("torch_autotune_train_step").main(
        ["--smoke", "--arch", "qwen1.5-0.5b", "--budget", "1",
         "--train-samples", "1", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert set(rec) == STEP_TUNE_KEYS
    assert rec["budget"] == 1 and rec["train_samples"] == 1
    for label in ("profile", "random"):
        assert set(rec[label]) == {"best_ms", "best_config", "steps"}
        assert rec[label]["steps"] == 1 and rec[label]["best_ms"] > 0
    assert rec["space"] == 256


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_serve_batch", ["--smoke"]),
    ("torch_train_lm", ["--steps", "1"])])
def test_an_example_raises_without_a_card(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main(argv)
