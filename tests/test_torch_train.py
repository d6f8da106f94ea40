"""The port's training path (``repro_torch.train``, ``repro_torch.optim``,
``repro_torch.distributed.compression`` and the models' differentiable
losses) against the JAX package's, on the CPU.

Each SMOKE arch's JAX params are drawn once and carried into the port
(``params_from_jax``, ``train_state_from_jax``); the batches come from the
data pipeline, which both packages share bit for bit.  The port's GQA
attention runs its kernel's plain version forward here (CPU tensors) and
differentiates through ``KernelAttention``, whose backward recomputes the
plain model attention.

Tolerances, all fp32 on both sides, the sums in another order:
- the loss within 1e-5 relative, each gradient leaf within 1e-4 relative
  L2 (about 1e-6 measured);
- a train step's loss, gradient norm and learning rate within 1e-4
  relative;
- AdamW, the clip and the schedules on identical numpy gradients within
  1e-6 (relative to the largest magnitude of the leaf);
- ``KernelAttention``'s gradients against autograd through the plain
  attention within 1e-6 (the backward is that recompute; the forward is the
  kernel's plain version, 3xTF32 emulated).
Parameters after a step are not compared element by element: AdamW's
first step divides each moment by its own square root, so where a
gradient is near 0 the two packages' updates may differ by up to 2 lr.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.distributed.compression import \
    quantize_dequantize_tree as jquantize
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as JO
from repro.train.train_step import StepConfig as JStepConfig
from repro.train.train_step import init_train_state as jinit
from repro.train.train_step import make_train_step as jmake_step
from repro_torch.checkpoint.checkpointer import stacked
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.distributed.compression import quantize_dequantize_tree
from repro_torch.models import attention as MA
from repro_torch.models.common import REMAT_POLICIES
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.registry import build_model as pbuild
from repro_torch.optim import adamw as PO
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          loss_and_grads, make_train_step)

ARCHS = ["qwen1.5-0.5b", "qwen2.5-3b", "gemma-2b", "command-r-plus-104b",
         "llama4-scout-17b-a16e", "deepseek-v2-236b", "internvl2-76b",
         "zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]
LOSS_RTOL, GRAD_RTOL, STEP_RTOL, OPT_TOL, ATTN_TOL = 1e-5, 1e-4, 1e-4, \
    1e-6, 1e-6
BATCH, SEQ = 2, 16


def _batch(cfg, step=0, batch=BATCH):
    return make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=batch,
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
        frontend_dim=cfg.frontend_dim), step)


def _flat(tree, prefix=""):
    """Nested dicts as {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_side(arch: str, remat: str):
    """The JAX params (seed 1) and JAX's loss and gradients on the batch."""
    jm = jbuild(JSMOKES[arch])
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _batch(PSMOKES[arch])
    loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jm.loss, remat=remat)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, jp), float(loss), _flat(grads), batch


def _rel_l2(port: torch.Tensor, ref: np.ndarray) -> float:
    a = port.detach().double().numpy()
    b = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    jp, jloss, jgrads, batch = _jax_side(arch, remat)
    cfg = PSMOKES[arch]
    params = params_from_jax(cfg, jp).requires_grad_()
    loss, grads = loss_and_grads(pbuild(cfg), params,
                                 to_device(batch, "cpu"),
                                 StepConfig(remat=remat))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    port = stacked(grads)
    assert set(port) == set(jgrads)
    for key, g in port.items():
        assert _rel_l2(g, jgrads[key]) < GRAD_RTOL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_gets_a_gradient(arch):
    cfg = PSMOKES[arch]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        "cpu").requires_grad_()
    names, leaves = zip(*params.named_parameters())
    loss = model.loss(params, to_device(_batch(cfg), "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    assert not missing
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b",
                                  "llama4-scout-17b-a16e", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_all_four_remat_policies_give_the_same_gradients(arch):
    """Remat changes what is kept, not what is computed: the gradients of
    every policy within 1e-6 relative L2 of "none"'s.  (A product written
    in place after a policy saved it would be handed back changed.)"""
    cfg = PSMOKES[arch]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        "cpu").requires_grad_()
    batch = to_device(_batch(cfg), "cpu")
    ref_loss, ref = loss_and_grads(model, params, batch,
                                   StepConfig(remat="none"))
    for policy in REMAT_POLICIES[1:]:
        loss, grads = loss_and_grads(model, params, batch,
                                     StepConfig(remat=policy))
        assert float(loss) == float(ref_loss), policy
        for k, g in grads.items():
            err = float((g - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
            assert err < 1e-6, (policy, k, err)


def test_an_unknown_remat_policy_is_refused():
    cfg = PSMOKES["qwen1.5-0.5b"]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat policy"):
        model.loss(params, to_device(_batch(cfg), "cpu"), remat="dots")


# --- one train step of both packages ------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_step(arch: str, microbatches: int, compress: bool):
    jm = jbuild(JSMOKES[arch])
    opt = JO.AdamW(lr=JO.warmup_cosine(1e-3, 3, 10))
    state = jinit(jm, opt, jax.random.PRNGKey(1))
    batch = _batch(PSMOKES[arch], step=3, batch=4)
    scfg = JStepConfig(remat="none", microbatches=microbatches,
                       compress_cross_pod=compress)
    new, metrics = jax.jit(jmake_step(jm, opt, scfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in metrics.items()}, batch


def _port_step(arch, jstate, batch, microbatches, compress):
    cfg = PSMOKES[arch]
    state = train_state_from_jax(cfg, jstate)
    opt = PO.AdamW(lr=PO.warmup_cosine(1e-3, 3, 10))
    scfg = StepConfig(remat="none", microbatches=microbatches,
                      compress_cross_pod=compress)
    return make_train_step(pbuild(cfg), opt, scfg)(
        state, to_device(batch, "cpu"))


@pytest.mark.parametrize("microbatches,compress",
                         [(1, False), (2, False), (1, True)])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b"])
def test_one_train_step_matches_jax(arch, microbatches, compress):
    jstate, jm, batch = _jax_step(arch, microbatches, compress)
    state, pm = _port_step(arch, jstate, batch, microbatches, compress)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(pm[key]) - jm[key]) <= STEP_RTOL * abs(jm[key]), \
            (key, float(pm[key]), jm[key])
    assert int(state.step) == 1 and int(state.opt.count) == 1


def test_two_microbatches_match_one():
    """The fp32 accumulators over two halves give the whole batch's loss
    and gradient norm (1e-5 relative: the halves' means averaged)."""
    arch = "qwen1.5-0.5b"
    jstate, _, batch = _jax_step(arch, 1, False)
    _, one = _port_step(arch, jstate, batch, 1, False)
    _, two = _port_step(arch, jstate, batch, 2, False)
    for key in ("loss", "grad_norm"):
        assert abs(float(two[key]) - float(one[key])) \
            <= 1e-5 * abs(float(one[key])), key


def test_the_int8_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((64, 48)).astype(np.float32) * 3,
             "b": rng.standard_normal(48).astype(np.float32) * 1e-3,
             "z": np.zeros(5, np.float32)}
    want = jquantize({k: jnp.asarray(v) for k, v in grads.items()})
    got = quantize_dequantize_tree({k: torch.from_numpy(v)
                                    for k, v in grads.items()})
    for k, v in grads.items():
        scale = float(np.abs(v).max())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-7 * max(scale, 1e-30))
        assert float((got[k] - torch.from_numpy(v)).abs().max()) \
            <= scale / 127.0 + 1e-6


# --- the optimizer on identical gradients ---------------------------------------
def _close(port: torch.Tensor, ref, tol=OPT_TOL):
    ref = np.asarray(ref, np.float64)
    err = np.abs(port.detach().double().numpy() - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), err


@pytest.mark.parametrize("schedule", ["warmup_cosine", "constant_lr"])
def test_adamw_matches_jax_on_identical_gradients(schedule):
    """Five updates of fp32 leaves from the same numpy gradients: updates,
    moments and count match; and a bf16 leaf's update is cast and added
    in bf16 on both sides."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 6), "b": (6,), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    make = {"warmup_cosine": lambda m: m.warmup_cosine(1e-2, 2, 5),
            "constant_lr": lambda m: m.constant_lr(1e-2)}[schedule]
    jopt, popt = JO.AdamW(lr=make(JO)), PO.AdamW(lr=make(PO))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jupd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp)
        pupd, ps = popt.update({k: torch.from_numpy(v) for k, v in g.items()},
                               ps, pp)
        jp = JO.apply_updates(jp, jupd)
        PO.apply_updates(pp, pupd)
        for k in shapes:
            _close(pupd[k], jupd[k])
            _close(ps.m[k], js.m[k])
            _close(ps.v[k], js.v[k])
            _close(pp[k], jp[k])
        assert int(ps.count) == int(js.count)
        _close(popt.lr(ps.count), jopt.lr(js.count))
    pb = {"w": torch.from_numpy(params["a"]).to(torch.bfloat16)}
    jb = {"w": jnp.asarray(params["a"]).astype(jnp.bfloat16)}
    g = rng.standard_normal(shapes["a"]).astype(np.float32)
    pu, _ = popt.update({"w": torch.from_numpy(g)}, popt.init(pb), pb)
    ju, _ = jopt.update({"w": jnp.asarray(g)}, jopt.init(jb), jb)
    assert pu["w"].dtype == torch.bfloat16
    PO.apply_updates(pb, pu)
    want = np.asarray(JO.apply_updates(jb, ju)["w"].astype(jnp.float32))
    assert np.array_equal(pb["w"].float().numpy(), want)


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32) * 4,
         "b": rng.standard_normal(8).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        jc, jn = JO.clip_by_global_norm({k: jnp.asarray(v)
                                         for k, v in g.items()}, max_norm)
        pc, pn = PO.clip_by_global_norm({k: torch.from_numpy(v)
                                         for k, v in g.items()}, max_norm)
        _close(pn, jn)
        for k in g:
            _close(pc[k], jc[k])
    assert float(PO.global_norm({k: torch.from_numpy(v)
                                 for k, v in g.items()})) \
        == pytest.approx(float(JO.global_norm(g)), rel=OPT_TOL)


@pytest.mark.parametrize("warmup,total", [(1, 10), (3, 10), (10, 100)])
def test_schedules_match_jax_on_an_int32_count(warmup, total):
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total,
                 total + 5):
        jv = JO.warmup_cosine(3e-4, warmup, total)(jnp.int32(step))
        pv = PO.warmup_cosine(3e-4, warmup, total)(
            torch.tensor(step, dtype=torch.int32))
        _close(pv, jv)
    assert float(PO.constant_lr(2e-3)(torch.tensor(4, dtype=torch.int32))) \
        == float(JO.constant_lr(2e-3)(jnp.int32(4)))


# --- KernelAttention ---------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_attention_gradient_is_the_plain_attentions(causal):
    """q (B, S, H, D) over k, v (B, S, Hkv, D) with H = 2 Hkv through
    ``kernel_attention`` (the repeat and casts outside the Function) and
    through autograd over the plain model attention, which takes the kv
    heads directly: output and q/k/v gradients within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    shapes = ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))
    base = [torch.randn(s, generator=gen) for s in shapes]
    g = torch.randn(shapes[0], generator=gen)

    def leaves():
        return [t.clone().requires_grad_() for t in base]

    qk, kk, vk = leaves()
    out_k = MA.kernel_attention(qk, kk, vk, causal=causal, chunk=16)
    got = (out_k, *torch.autograd.grad(out_k, (qk, kk, vk), g))
    qp, kp, vp = leaves()
    plain = MA.plain_causal_attention if causal else MA.chunked_attention
    out_p = plain(qp, kp, vp, chunk=16)
    want = (out_p, *torch.autograd.grad(out_p, (qp, kp, vp), g))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.detach(), b.detach()
        err = float((a - b).abs().max() / b.abs().max())
        assert err < ATTN_TOL, (name, err)


def test_kernel_attention_saves_only_q_k_v():
    q, k, v = (torch.randn(1, 2, 24, 16, requires_grad=True)
               for _ in range(3))
    out = MA.KernelAttention.apply(q, k, v, True, MA.KV_CHUNK)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    assert all(s.shape == q.shape and s.dtype == torch.float32
               for s in saved)


def test_a_serving_model_stays_frozen():
    """``Model.init`` gives frozen parameters (serving); the train state's
    are trainable."""
    cfg = PSMOKES["qwen1.5-0.5b"]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    state = init_train_state(model, PO.AdamW(lr=PO.constant_lr(1e-3)),
                             torch.Generator().manual_seed(0), "cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert all(m.dtype == torch.float32 for m in state.opt.m.values())
    assert set(state.opt.m) == {n for n, _ in
                                state.params.named_parameters()}
