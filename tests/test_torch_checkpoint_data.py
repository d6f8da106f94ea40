"""The port's data pipeline, checkpointer and train/supervisor CLIs against
the JAX package's, on the CPU.

- ``make_batch`` gives the JAX package's batches bit for bit.
- Checkpoints have one layout in both packages: a JAX-written checkpoint
  restores into the port, and a port-written fp32 one into the JAX
  package, every leaf exact (the stacked leaves keep their layers axes).
- bf16: the JAX checkpointer writes a bf16 leaf as the 2-byte void
  ``numpy.asarray`` gives it (``|V2``) and restores it as that void, which
  JAX refuses as an array (ROADMAP.md, queue 3); the port restores those
  bytes as bf16, bit for bit, where its template's leaf is bf16.
- keep-last-k, the atomic publish (a partial ``.tmp`` write is never
  listed), a failed write raised by ``wait``.
- ``launch.supervisor`` re-executes ``launch.train --smoke --device cpu``
  after its trainer is SIGKILLed past its first checkpoint, and the run
  ends at the uninterrupted run's final loss (the CPU step is
  deterministic: the printed losses are equal).
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import SMOKES as JSMOKES
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as JO
from repro.train.train_step import StepConfig as JStepConfig
from repro.train.train_step import init_train_state as jinit
from repro.train.train_step import make_train_step as jmake_step
from repro_torch.checkpoint.checkpointer import (Checkpointer, leaf_key,
                                                 state_arrays)
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.registry import build_model as pbuild
from repro_torch.optim import adamw as PO
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]


# --- data ---------------------------------------------------------------------
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (123, 1000)])
@pytest.mark.parametrize("frontend", ["vision", "audio"])
def test_make_batch_is_the_jax_packages_bit_for_bit(frontend, seed, step):
    kw = dict(vocab_size=512, seq_len=96, global_batch=3, seed=seed,
              mean_doc_len=32, frontend=frontend, frontend_len=5,
              frontend_dim=12)
    got = make_batch(DataConfig(**kw), step)
    want = jmake_batch(JDataConfig(**kw), step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    on = to_device(got, "cpu")
    assert all(np.array_equal(on[k].numpy(), got[k]) for k in got)


# --- checkpoints across the two packages -------------------------------------------
def _jax_state_after_a_step(arch: str, dtype: str = "float32"):
    cfg = dataclasses.replace(JSMOKES[arch], dtype=dtype)
    jm = jbuild(cfg)
    opt = JO.AdamW(lr=JO.constant_lr(1e-3))
    state = jinit(jm, opt, jax.random.PRNGKey(1))
    batch = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
        frontend_dim=cfg.frontend_dim), 0)
    state, _ = jax.jit(jmake_step(jm, opt, JStepConfig(remat="none")))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, batch


def _jax_leaves(state):
    """The JAX checkpointer's host arrays of ``state``."""
    from repro.checkpoint.checkpointer import _flatten
    return {k: np.asarray(v) for k, v in _flatten(state)}


def _port_template(arch: str, dtype: str = "float32"):
    cfg = PSMOKES[arch].scaled(dtype=dtype)
    return init_train_state(pbuild(cfg), PO.AdamW(lr=PO.constant_lr(1e-3)),
                            torch.Generator().manual_seed(5), "cpu")


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_a_jax_checkpoint_restores_into_the_port(arch, tmp_path):
    jstate, _ = _jax_state_after_a_step(arch)
    jc = JCheckpointer(str(tmp_path))
    jc.save(1, jstate)
    jc.wait()
    step, state = Checkpointer(str(tmp_path)).restore_latest(
        _port_template(arch))
    assert step == 1 and int(state.step) == 1 and int(state.opt.count) == 1
    want = _jax_leaves(jstate)
    got = state_arrays(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), k


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b"])
def test_a_port_checkpoint_restores_into_jax(arch, tmp_path):
    jstate, batch = _jax_state_after_a_step(arch)
    cfg = PSMOKES[arch]
    state = train_state_from_jax(cfg, jstate)
    state, _ = make_train_step(pbuild(cfg), PO.AdamW(
        lr=PO.constant_lr(1e-3)), StepConfig(remat="none"))(
        state, to_device(batch, "cpu"))
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    ck.wait()
    restored = JCheckpointer(str(tmp_path)).restore(2, jstate)
    got = _jax_leaves(restored)
    want = state_arrays(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert int(restored.step) == 2 and int(restored.opt.count) == 2


def test_jax_checkpointer_cannot_restore_bf16_but_the_port_restores_its_bits(
        tmp_path):
    """The reference fault: the JAX checkpointer saves a bf16 leaf as
    ``|V2`` and restores it as ``|V2``, which ``jnp.asarray`` refuses; the
    port restores the same file's bf16 leaves bit for bit."""
    jstate, _ = _jax_state_after_a_step("qwen1.5-0.5b", "bfloat16")
    jc = JCheckpointer(str(tmp_path))
    jc.save(1, jstate)
    jc.wait()
    restored = jc.restore(1, jstate)
    leaf = restored.params["embed"]
    assert leaf.dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(leaf)
    _, state = Checkpointer(str(tmp_path)).restore_latest(
        _port_template("qwen1.5-0.5b", "bfloat16"))
    assert state.params["embed"].dtype == torch.bfloat16
    want = _jax_leaves(jstate)
    got = state_arrays(state)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def test_a_port_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    state = _port_template("zamba2-2.7b", "bfloat16")
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(3, state)
    with np.load(tmp_path / "step_0000000003" / "arrays.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
        assert z["params/supers/mamba/w_in"].shape[:2] == (
            len(state.params["supers"]), len(state.params["supers"][0]))
    _, back = ck.restore_latest(_port_template("zamba2-2.7b", "bfloat16"))
    for (n, p), (_, q) in zip(state.params.named_parameters(),
                              back.params.named_parameters()):
        assert q.dtype == torch.bfloat16 and torch.equal(p, q), n


def test_a_leaf_of_another_dtype_or_shape_is_refused(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, _port_template("qwen1.5-0.5b", "bfloat16"))
    with pytest.raises(ValueError, match="bf16 leaf"):
        ck.restore(1, _port_template("qwen1.5-0.5b"))
    with pytest.raises((ValueError, KeyError)):
        ck.restore(1, _port_template("qwen2.5-3b", "bfloat16"))


def test_leaf_keys_drop_the_layer_indices():
    assert leaf_key("embed") == ("embed", ())
    assert leaf_key("blocks.3.attn.wq") == ("blocks/attn/wq", (3,))
    assert leaf_key("supers.1.2.mamba.w_in") == ("supers/mamba/w_in", (1, 2))


def test_keeps_the_last_k_and_never_lists_a_partial_write(tmp_path):
    state = _port_template("qwen1.5-0.5b")
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in range(1, 6):
        ck.save(step, state)
    ck.wait()
    assert ck.all_steps() == [4, 5]
    # a write cut short leaves only its .tmp directory, never listed
    (tmp_path / "step_0000000009.tmp").mkdir()
    (tmp_path / "step_0000000009.tmp" / "arrays.npz").write_bytes(b"cut")
    assert ck.latest_step() == 5
    step, _ = ck.restore_latest(_port_template("qwen1.5-0.5b"))
    assert step == 5


def test_a_failed_write_is_raised_by_wait(tmp_path):
    """A step published twice cannot be renamed over (the JAX
    checkpointer's writer thread drops that error); the port raises it."""
    state = _port_template("qwen1.5-0.5b")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    ck.save(1, state)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ck.wait()
    assert ck.all_steps() == [1]


def test_the_writer_copies_the_state_before_the_next_step(tmp_path):
    """The state is copied to the host when ``save`` returns: a step that
    updates the parameters in place meanwhile changes nothing saved."""
    state = _port_template("qwen1.5-0.5b")
    before = {k: v.copy() for k, v in state_arrays(state).items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    ck.wait()
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as z:
        for k, v in before.items():
            assert np.array_equal(z[k], v), k


# --- the CLIs ---------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
              "--steps", "40", "--batch", "2", "--seq", "32",
              "--ckpt-every", "4"]


def _final_loss(out: str) -> str:
    return [x for x in out.splitlines()
            if x.startswith("[train] done: final loss")][-1]


def _children(pid: int):
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                stat = Path(f"/proc/{name}/stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(name))
    return out


def test_the_supervisor_resumes_a_killed_trainer_to_the_same_loss(tmp_path):
    whole = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--ckpt-dir", str(tmp_path / "whole")],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert whole.returncode == 0, whole.stderr[-3000:]
    sup = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.supervisor", "--backoff",
         "0.1", "--", *TRAIN_ARGS, "--ckpt-dir", str(tmp_path / "killed")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=ROOT)
    try:
        first = tmp_path / "killed" / "step_0000000004"
        deadline = time.time() + 300
        while not first.exists():
            assert sup.poll() is None and time.time() < deadline
            time.sleep(0.005)
        trainers = _children(sup.pid)
        assert len(trainers) == 1
        os.kill(trainers[0], signal.SIGKILL)
        out, _ = sup.communicate(timeout=600)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(timeout=60)
    assert sup.returncode == 0, out[-3000:]
    assert "[supervisor] attempt 1" in out
    restored = [x for x in out.splitlines()
                if x.startswith("[train] restored checkpoint at step")]
    assert len(restored) == 1 and int(restored[0].split()[-1]) >= 4
    assert _final_loss(out) == _final_loss(whole.stdout)


def test_the_watchdog_exits_42_on_a_wedged_step(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--step-timeout", "1e-4"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode == 42
    assert "[watchdog] step exceeded timeout" in out.stdout


def test_a_sharded_mesh_is_refused_naming_the_roadmap_item():
    # the sharded step is ported: --data-model 2 1 trains on two ranks
    # (tests/test_torch_sharded_cli.py); a mesh with an empty axis is what
    # the CLI refuses now
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--data-model", "0", "2"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode == 2
    assert "--data-model takes two positive extents" in out.stderr
