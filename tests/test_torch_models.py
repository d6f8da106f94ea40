"""The port's model zoo (``repro_torch.models``) against the JAX package's
(``repro.models``), arch by arch, on the CPU.

For each SMOKE config of the model zoo (the transformer families:
qwen1.5, qwen2.5, gemma, command-r, llama4-scout, deepseek-v2, internvl2
with its patch embeddings; Zamba2, xLSTM, and SeamlessM4T with its frames)
the JAX params are drawn once and carried into the port with
``params_from_jax``; the same inputs, made from a numpy seed, go through
both: ``prefill`` (last-position logits and the whole cache, nested caches
leaf by leaf), 4 teacher-forced ``decode`` steps (each step's logits and
the cache after them; both sides are fed JAX's greedy tokens) and
``loss``.  The port's GQA prefill runs its attention kernel's plain version
here (CPU tensors).

Tolerance, fp32: max |port - JAX| <= 1e-4 x max |JAX| for logits and
caches, and 1e-4 relative for the loss.  Both sides compute in fp32; what
differs is the order of the sums (the kernel's plain version against the
JAX package's chunked online softmax, torch's GEMMs against XLA's), about
1e-6 here.

One bf16 case (qwen2.5 at SMOKE width, ``dtype="bfloat16"``): logits and
cache within 5e-2 x max |JAX|.  In bf16 the JAX package rounds q·scale
and p to bf16 inside its attention while the port's kernel keeps fp32,
and the two CPUs round each bf16 GEMM's result after sums of different
order; a bf16 ulp is 2**-8 of a value, and 5e-2 allows about a dozen ulps
of the largest logit after two layers (1.6e-2 measured).  The greedy
first tokens must agree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models.registry import build_model as jbuild
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.kernels.attention import kernel as K
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as pbuild

ARCHS = ["qwen1.5-0.5b", "qwen2.5-3b", "gemma-2b", "command-r-plus-104b",
         "llama4-scout-17b-a16e", "deepseek-v2-236b", "internvl2-76b",
         "zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]
RTOL = 1e-4
BF16_RTOL = 5e-2
BATCH, PROMPT, MAX_SEQ, STEPS = 2, 11, 24, 4


def _rel(port, ref) -> float:
    a = np.asarray(ref, np.float64)
    b = port.double().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


def _flat(cache, prefix=""):
    """A nested cache as {"a/b": leaf}."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(BATCH, PROMPT))
             .astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size,
                          size=(BATCH, PROMPT)).astype(np.int32)
    return batch, labels


@functools.lru_cache(maxsize=None)
def _run(arch: str, dtype: str = "float32"):
    """Both sides on one arch: the JAX model run once (prefill, 4 decode
    steps fed its own greedy tokens, loss), the port's module carried from
    the JAX params, and what the port gives on the same inputs."""
    jcfg = dataclasses.replace(JSMOKES[arch], dtype=dtype)
    pcfg = PSMOKES[arch].scaled(dtype=dtype)
    jm, pm = jbuild(jcfg), pbuild(pcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, jp))
    batch, labels = _inputs(jcfg)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        max_seq=MAX_SEQ)
    pl, pc = pm.prefill(pp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, MAX_SEQ)
    out = {"prefill": (_np(jl), pl),
           "cache": ({k: _np(v) for k, v in _flat(jc).items()},
                     {k: v.clone() for k, v in _flat(pc).items()}),
           "decode": [], "cfg": pcfg}
    if dtype == "bfloat16":
        return out
    tok = _np(jl)[:, -1].argmax(-1).astype(np.int32)
    for _ in range(STEPS):
        jl, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(tok[:, None])})
        pl, pc = pm.decode(pp, pc, {"tokens": torch.from_numpy(tok[:, None])})
        out["decode"].append((_np(jl), pl))
        tok = _np(jl)[:, -1].argmax(-1).astype(np.int32)
    out["cache_after"] = ({k: _np(v) for k, v in _flat(jc).items()},
                          _flat(pc))
    lb = dict(batch, labels=labels)
    out["loss"] = (float(jm.loss(jp, {k: jnp.asarray(v)
                                      for k, v in lb.items()})),
                   float(pm.loss(pp, {k: torch.from_numpy(v)
                                      for k, v in lb.items()})))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    r = _run(arch)
    jl, pl = r["prefill"]
    assert tuple(pl.shape) == jl.shape == (BATCH, 1, r["cfg"].padded_vocab)
    assert _rel(pl, jl) <= RTOL
    jc, pc = r["cache"]
    assert set(pc) == set(jc)
    for k in jc:
        assert tuple(pc[k].shape) == jc[k].shape, k
        if k.endswith("pos"):
            assert pc[k].tolist() == jc[k].tolist(), k
        else:
            assert _rel(pc[k], jc[k]) <= RTOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    r = _run(arch)
    assert len(r["decode"]) == STEPS
    for step, (jl, pl) in enumerate(r["decode"]):
        assert tuple(pl.shape) == jl.shape, step
        assert _rel(pl, jl) <= RTOL, step
    jc, pc = r["cache_after"]
    cfg = r["cfg"]
    assert set(pc) == set(jc)
    for k in jc:
        if k.endswith("pos"):
            # every layer's position: prompt (and the vision prefix) plus
            # the steps; an encoder's frames take no position
            pos = PROMPT + STEPS + (cfg.frontend_len
                                    if cfg.frontend == "vision" else 0)
            assert pc[k].tolist() == jc[k].tolist(), k
            assert set(np.asarray(jc[k]).ravel().tolist()) == {pos}, k
        else:
            assert _rel(pc[k], jc[k]) <= RTOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    jloss, ploss = _run(arch)["loss"]
    assert np.isfinite(ploss)
    assert abs(ploss - jloss) <= RTOL * abs(jloss)


def test_bf16_prefill_matches_jax_within_its_own_tolerance():
    r = _run("qwen2.5-3b", "bfloat16")
    jl, pl = r["prefill"]
    assert pl.dtype == torch.bfloat16
    assert _rel(pl.float(), jl) <= BF16_RTOL
    assert (pl.float().numpy()[:, -1].argmax(-1)
            == jl[:, -1].argmax(-1)).all()
    jc, pc = r["cache"]
    for k in ("k", "v"):
        assert pc[k].dtype == torch.bfloat16
        assert _rel(pc[k].float(), jc[k]) <= BF16_RTOL, k


def test_prefill_attention_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the model's GQA prefill reaches the kernel's wrapper,
    which takes ``flash_attention_plain``: one call a layer, no launch."""
    calls = []
    plain = K.flash_attention_plain

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(K, "flash_attention_plain", spy)
    cfg = PSMOKES["qwen2.5-3b"]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    before = K.flash_attention.launches
    model.prefill(params, {"tokens": torch.ones((2, 9), dtype=torch.int32)},
                  16)
    assert calls == [(2, cfg.n_heads, 9, cfg.eff_head_dim)] * cfg.n_layers
    assert K.flash_attention.launches == before
