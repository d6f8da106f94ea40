"""The port's sharded train step on gloo groups of 2, 4 and 8 ranks on
localhost (``tests/_torch_sharding_ranks.py``), against JAX's unsharded
``value_and_grad`` and the port's unsharded step, on the CPU.

The three groups start at once in the background (``sharded``) and each
runs all of its cases: every SMOKE arch on 2x1 and 2x2 meshes, qwen2.5-3b
on 1x4 (its kv heads whole while its query heads split) and on the JAX
test's 4x2, and two microbatches on 2x2.  Tolerances, fp32 on both sides,
the sums in another order:
- the loss and every gathered gradient within 1e-4 of JAX's (relative;
  gradients relative L2 a leaf), and within 1e-5 of the port's unsharded
  step (a leaf's norm floored at 1e-2 of the whole gradient's,
  ``LEAF_FLOOR``), the gradient norm too;
- one AdamW step (``apply_gradients``: clip, AdamW on each rank's local
  shards) within 1e-5 of the unsharded ``apply_gradients`` of the same
  gathered gradients (max |difference| over the leaf's largest
  magnitude): the optimizer's sharding alone, since AdamW's first step
  divides each gradient by its own magnitude and so turns reordering noise
  in a near-zero gradient into a difference of up to the learning rate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharding_ranks as R
from repro.configs import SMOKES as JSMOKES
from repro.models.registry import build_model as jbuild
from repro_torch.checkpoint.checkpointer import stacked
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.data.pipeline import make_batch, to_device
from repro_torch.models.registry import build_model as pbuild
from repro_torch.optim.adamw import AdamW, constant_lr
from repro_torch.train.train_step import (StepConfig, TrainState,
                                          apply_gradients, loss_and_grads,
                                          make_train_step)
from test_torch_sharding import (ARCHS, BATCH, _jax_params, _leaves,
                                 _port_params)

JAX_TOL, PORT_TOL, STEP_TOL = 1e-4, 1e-5, 1e-5
# a leaf's gradient against the port's unsharded one: relative L2, its norm
# floored at this share of the whole gradient's.  A small leaf that sums
# many terms with cancellation carries fp32 reordering noise of the size of
# its terms times the epsilon, not of its own: Mamba2's a_log 2e-8
# absolute (1.5e-5 of its own norm) on a 2x2 mesh, its dt_bias 5.5e-8
# (1.2e-5) on 2x1, against a whole gradient of norm 5.3
LEAF_FLOOR = 1e-2


def _batch(cfg, step=0):
    return make_batch(R.data_config(cfg, BATCH), step)


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """JAX's loss and gradients on the batch, from its params (seed 1)."""
    jm = jbuild(JSMOKES[arch])
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _jax_params(arch)),
        {k: jnp.asarray(v) for k, v in _batch(PSMOKES[arch]).items()})
    return float(loss), {"/".join(p): np.asarray(g)
                         for p, g in _leaves(grads)}


@functools.lru_cache(maxsize=None)
def _port_side(arch, microbatches=1):
    """The port's unsharded loss, gradients and step metrics, from the JAX
    params."""
    cfg = PSMOKES[arch]
    model = pbuild(cfg)
    params = _port_params(arch).requires_grad_()
    batch = to_device(_batch(cfg), "cpu")
    scfg = StepConfig(microbatches=microbatches)
    loss, grads = loss_and_grads(model, params, batch, scfg)
    opt = AdamW(lr=constant_lr(R.LR))
    state = TrainState(params=params,
                       opt=opt.init(dict(params.named_parameters())),
                       step=torch.zeros((), dtype=torch.int32))
    _, metrics = make_train_step(model, opt, scfg)(state, batch)
    return {"loss": float(loss), "grads": grads,
            "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])}


def _params_after(arch, grads):
    """The parameters after the port's unsharded ``apply_gradients`` of
    ``grads`` (the sharded run's, gathered) to the JAX params."""
    model = pbuild(PSMOKES[arch])
    params = _port_params(arch)
    opt = AdamW(lr=constant_lr(R.LR))
    state = TrainState(params=params,
                       opt=opt.init(dict(params.named_parameters())),
                       step=torch.zeros((), dtype=torch.int32))
    state, _ = apply_gradients(state, grads, opt, StepConfig())
    del model
    return {k: p.detach() for k, p in state.params.named_parameters()}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# every sharded run of the module, (mesh, arch, microbatches), by group
PLANS = {
    2: [((2, 1), a, 1) for a in ARCHS],
    4: [((2, 2), a, 1) for a in ARCHS] + [((1, 4), "qwen2.5-3b", 1),
                                         ((2, 2), "qwen1.5-0.5b", 2)],
    8: [((4, 2), "qwen2.5-3b", 1)],
}
GROUP_TIMEOUT = 420


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The three groups, started at once in the background (their ranks
    single-threaded), each running its plan; ``sharded(shape, arch, mb)``
    waits for the group and loads rank 0's result."""
    root = tmp_path_factory.mktemp("sharded")
    indir, outdir = root / "in", root / "out"
    indir.mkdir()
    outdir.mkdir()
    for arch in ARCHS:
        torch.save({k: p.detach().clone() for k, p in
                    _port_params(arch).named_parameters()},
                   indir / f"{arch}.pt")
    groups = {w: R.start_group(w, R.step_case, plan, BATCH, str(indir),
                               str(outdir)) for w, plan in PLANS.items()}
    done = set()

    def result(shape, arch, mb=1):
        world = next(w for w, plan in PLANS.items()
                     if (shape, arch, mb) in plan)
        if world not in done:
            done.add(world)
            R.wait_group(groups[world], GROUP_TIMEOUT)
        return torch.load(outdir / f"{shape[0]}x{shape[1]}-{arch}-mb{mb}.pt")

    yield result
    for w, ctx in groups.items():
        if w not in done:        # no test of the selection waited for it
            R.stop_group(ctx)


def _check_sharded(got, arch):
    jloss, jgrads = _jax_side(arch)
    port = _port_side(arch)
    assert abs(got["loss"] - jloss) <= JAX_TOL * abs(jloss)
    assert abs(got["loss"] - port["loss"]) <= PORT_TOL * abs(port["loss"])
    g = stacked(got["grads"])
    assert set(g) == set(jgrads)
    for key, t in g.items():
        assert _rel_l2(t.numpy(), jgrads[key]) < JAX_TOL, (arch, key)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum())
                              for g in port["grads"].values())))
    for k, t in got["grads"].items():
        want = port["grads"][k].double().numpy()
        err = np.linalg.norm(t.double().numpy() - want)
        assert err < PORT_TOL * max(np.linalg.norm(want),
                                    LEAF_FLOOR * total), (arch, k)
    assert abs(got["grad_norm"] - port["grad_norm"]) \
        <= PORT_TOL * port["grad_norm"]
    want = _params_after(arch, got["grads"])
    for k, t in got["params"].items():
        assert _rel_max(t.numpy(), want[k].numpy()) < STEP_TOL, (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_arch_trains_on_a_2x1_mesh(sharded, arch):
    """FSDP and data parallelism over two ranks."""
    _check_sharded(sharded((2, 1), arch), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_arch_trains_on_a_2x2_mesh(sharded, arch):
    _check_sharded(sharded((2, 2), arch), arch)


def test_query_heads_split_while_kv_heads_stay_whole_on_1x4(sharded):
    """qwen2.5-3b's 2 kv heads do not divide a 4-way model axis: they stay
    whole while its 4 query heads split, each paired with its kv head by
    global index."""
    _check_sharded(sharded((1, 4), "qwen2.5-3b"), "qwen2.5-3b")


def test_qwen_trains_on_the_jax_tests_4x2_mesh(sharded):
    _check_sharded(sharded((4, 2), "qwen2.5-3b"), "qwen2.5-3b")


def test_two_microbatches_on_a_2x2_mesh_match_the_unsharded_step(sharded):
    """``make_train_step`` with two microbatches (fp32 accumulators) on a
    2x2 mesh: its loss and gradient norm within 1e-5 of the unsharded
    step's with two microbatches."""
    got = sharded((2, 2), "qwen1.5-0.5b", 2)
    port = _port_side("qwen1.5-0.5b", 2)
    assert abs(got["loss"] - port["step_loss"]) \
        <= PORT_TOL * port["step_loss"]
    assert abs(got["grad_norm"] - port["grad_norm"]) \
        <= PORT_TOL * port["grad_norm"]
