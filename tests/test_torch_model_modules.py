"""The port's model modules against their JAX counterparts, function by
function, on the CPU: GQA prefill attention (the kernel's wrapper, whose
plain version runs on CPU tensors) against ``_causal_block_attention`` and
``_chunked_attention`` with S a multiple of the chunk and not, at
Hkv = 1, 2 and H; the whole GQA layer in prefill and decode; MLA prefill
and decode; both MoE dispatches; ``apply_rope``, ``rms_norm``, the cache
write at a clamped ``pos``; and the bookkeeping beside them (the configs,
parameter counts of all ten archs, the parameter draw).

Tolerance, fp32: max |port - JAX| <= 1e-4 x max |JAX| (the order of the
sums differs, about 1e-6 here); the configs, counts and cache writes are
exact.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SMOKES as JSMOKES
from repro.distributed import tuning as jdt
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.registry import build_model as jbuild
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.distributed import tuning as pdt
from repro_torch.kernels.attention import kernel as K
from repro_torch.models import attention as PA
from repro_torch.models import common as PC
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as pbuild

RTOL = 1e-4


def _rel(port, ref) -> float:
    a = np.asarray(ref, np.float64)
    b = port.double().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    """A JAX param dict as the port's functions read it."""
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _qkv(b, s, h, hkv, d, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv or d)).astype(np.float32)
    return q, k, v


# --- GQA prefill attention ----------------------------------------------------

@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("s,chunk", [(48, 16), (50, 16)],
                         ids=["s_multiple_of_chunk", "s_not"])
def test_gqa_prefill_attention_matches_both_jax_paths(s, chunk, hkv,
                                                      monkeypatch):
    """S a multiple of the chunk takes ``_causal_block_attention``'s
    block skipping, S not its fallback to ``_chunked_attention``; the port
    computes both through the kernel's wrapper (its plain version here).
    Hkv = 2 of 4 heads holds the head order: query head j reads kv head
    j // 2, as the JAX package's (b, s, hkv, rep, d) reshape does."""
    calls = []
    plain = K.flash_attention_plain
    monkeypatch.setattr(K, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = _qkv(2, s, 4, hkv, 16)
    got = PA.kernel_attention(_t(q), _t(k), _t(v))
    block = JA._causal_block_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), chunk=chunk)
    chunked = JA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, chunk=chunk)
    assert calls == [1]
    assert got.shape == (2, s, 4, 16)
    assert _rel(got, block) <= RTOL
    assert _rel(got, chunked) <= RTOL


def test_gqa_head_order_differs_from_tiling():
    """The kv heads are repeated with repeat_interleave (head j reads kv
    head j // rep), not tiled (j % Hkv): the two differ, and only the
    first is the JAX package's."""
    q, k, v = _qkv(1, 20, 4, 2, 8, seed=3)
    ref = np.asarray(JA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), True, chunk=8))
    got = PA.kernel_attention(_t(q), _t(k), _t(v))
    tiled = K.flash_attention_plain(
        _t(q).transpose(1, 2).contiguous(),
        _t(k).transpose(1, 2).repeat(1, 2, 1, 1).contiguous(),
        _t(v).transpose(1, 2).repeat(1, 2, 1, 1).contiguous()
    ).transpose(1, 2)
    assert _rel(got, ref) <= RTOL
    assert _rel(tiled, ref) > 1e-2


def test_plain_causal_attention_matches_jax_with_its_own_v_dim():
    q, k, v = _qkv(2, 40, 4, 4, 24, dv=16, seed=5)
    ref = JA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, chunk=16)
    got = PA.plain_causal_attention(_t(q), _t(k), _t(v))
    assert got.shape == (2, 40, 4, 16)
    assert _rel(got, ref) <= RTOL


# --- whole attention layers ---------------------------------------------------

def _attn_params(acfg, mla, seed=0):
    defs = JA.mla_defs(acfg) if mla else JA.gqa_defs(acfg)
    params = JC.init_params(jax.random.PRNGKey(seed), defs)
    if "bq" in params:       # non-zero biases, so that they are exercised
        rng = np.random.default_rng(seed)
        for b in ("bq", "bk", "bv"):
            params[b] = jnp.asarray(rng.standard_normal(
                params[b].shape).astype(np.float32))
    return params


GQA = JA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                    qkv_bias=True, rope_theta=1e6)
MLA = JA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                    kv_lora_rank=12, qk_rope_dim=4, v_head_dim=6)


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_attention_layer_prefill_and_decode_match_jax(mla):
    acfg = MLA if mla else GQA
    jfn, pfn = (JA.mla_apply, PA.mla_apply) if mla else (JA.gqa_apply,
                                                         PA.gqa_apply)
    p = _attn_params(acfg, mla)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, acfg.d_model)).astype(np.float32)
    jy, _ = jfn(p, acfg, jnp.asarray(x))
    py, kv = pfn(_tree(p), PA.AttnConfig(*acfg), _t(x))
    assert _rel(py, jy) <= RTOL
    # decode one token at pos 9 over a cache holding the prefix
    t = 12
    init = JA.mla_init_cache if mla else JA.gqa_init_cache
    cache = init(acfg, 2, t, jnp.float32)
    for name, val in kv.items():
        cache[name] = cache[name].at[:, :9].set(jnp.asarray(val.numpy()))
    cache["pos"] = jnp.int32(9)
    xt = rng.standard_normal((2, 1, acfg.d_model)).astype(np.float32)
    jy, jnew = jfn(p, acfg, jnp.asarray(xt), cache=cache)
    pcache = {k: _t(np.asarray(v)) for k, v in cache.items()}
    py, pnew = pfn(_tree(p), PA.AttnConfig(*acfg), _t(xt), cache=pcache)
    assert _rel(py, jy) <= RTOL
    assert set(pnew) == set(jnew)
    for k in jnew:
        assert _rel(pnew[k], jnew[k]) <= RTOL, k


def test_update_stacked_cache_clamps_pos_past_the_end_as_jax():
    """``dynamic_update_slice`` clamps a start past the cache's end, so a
    token decoded at pos >= max_seq lands in the last slot; the port gives
    that same result (and pos goes on counting)."""
    cfg = PSMOKES["qwen2.5-3b"].scaled(n_layers=2)
    jcfg = dataclasses.replace(JSMOKES["qwen2.5-3b"], n_layers=2)
    rng = np.random.default_rng(0)
    shape = (2, 2, 5, cfg.n_kv_heads, cfg.eff_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    new = {n: rng.standard_normal(shape[:2] + (1,) + shape[3:])
           .astype(np.float32) for n in ("k_new", "v_new")}
    for pos in (3, 5, 9):
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v),
                  "pos": jnp.full((2,), pos, jnp.int32)}
        jout = JT.update_stacked_cache(jcfg, jcache,
                                       {n: jnp.asarray(a)
                                        for n, a in new.items()})
        pcache = {"k": _t(k.copy()), "v": _t(v.copy()),
                  "pos": torch.full((2,), pos, dtype=torch.int32)}
        pout = PT.update_stacked_cache(cfg, pcache,
                                       {n: _t(a) for n, a in new.items()})
        for name in ("k", "v"):
            assert np.array_equal(pout[name].numpy(), np.asarray(jout[name]))
        assert pout["pos"].tolist() == np.asarray(jout["pos"]).tolist() \
            == [pos + 1] * 2


# --- MoE ----------------------------------------------------------------------

MOE = JM.MoEConfig(d_model=16, d_ff=24, n_experts=4, top_k=2, n_shared=1,
                   group_size=8)


@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
def test_moe_dispatch_matches_jax(dispatch):
    p = JC.init_params(jax.random.PRNGKey(2), JM.moe_defs(MOE))
    # a sharper router than the init's, so that the capacity buckets
    # overflow and drop tokens
    p["router"] = p["router"] * 50.0
    x = np.random.default_rng(4).standard_normal(
        (2, 12, MOE.d_model)).astype(np.float32)
    pcfg = PM.MoEConfig(*MOE)
    if dispatch == "capacity":
        jy, jaux = JM.moe_apply(p, MOE, jnp.asarray(x))
        py, paux = PM.moe_apply(_tree(p), pcfg, _t(x))
        assert abs(float(paux) - float(jaux)) <= RTOL * abs(float(jaux))
    else:
        jy = JM.moe_apply_dropless(p, MOE, jnp.asarray(x))
        py = PM.moe_apply_dropless(_tree(p), pcfg, _t(x))
    assert _rel(py, jy) <= RTOL


# --- elementary layers --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rms_norm_match_jax(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None, :] + 1000
    jdt_ = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x).astype(jdt_)
    px = _t(x).to(tdt)
    jr = JC.apply_rope(jx, jnp.asarray(pos), 1e6)
    pr = PC.apply_rope(px, _t(pos), 1e6)
    jn = JC.rms_norm(jx, jnp.asarray(gamma))
    pn = PC.rms_norm(px, _t(gamma))
    assert pr.dtype == pn.dtype == tdt
    # bf16: one rounding of the same fp32 value, at most an ulp apart
    tol = RTOL if dtype == "float32" else 2.0 ** -7
    assert _rel(pr.float(), np.asarray(jr.astype(jnp.float32))) <= tol
    assert _rel(pn.float(), np.asarray(jn.astype(jnp.float32))) <= tol


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(8)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 16), (16,), (16,)))
    jy = JC.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    assert _rel(PC.layer_norm(_t(x), _t(g), _t(b)), jy) <= RTOL


def test_gelu_mlp_uses_the_tanh_approximation_as_jax():
    p = JC.init_params(jax.random.PRNGKey(3), JC.mlp_defs(8, 16))
    x = np.random.default_rng(7).standard_normal((3, 8)).astype(np.float32)
    for act in ("silu", "gelu", "relu"):
        jy = JC.mlp_apply(p, jnp.asarray(x), act)
        py = PC.mlp_apply(_tree(p), _t(x), act)
        assert _rel(py, jy) <= RTOL, act


# --- configs, counts, parameters ----------------------------------------------

def test_configs_are_the_jax_packages():
    assert set(PARCHS) == set(JARCHS) and set(PSMOKES) == set(JSMOKES)
    for name in JARCHS:
        assert dataclasses.asdict(PARCHS[name]) \
            == dataclasses.asdict(JARCHS[name])
        assert dataclasses.asdict(PSMOKES[name]) \
            == dataclasses.asdict(JSMOKES[name])


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_param_counts_match_jax(name):
    cfg = PARCHS[name]
    assert pdt.arch_param_count(cfg) == jdt.arch_param_count(JARCHS[name])
    assert pdt.arch_active_param_count(cfg) \
        == jdt.arch_active_param_count(JARCHS[name])
    pm = pbuild(cfg)
    jm = jbuild(JARCHS[name])
    assert pm.param_count() == jm.param_count()
    assert pm.active_param_count() == jm.active_param_count()


def test_init_draws_the_jax_distributions_from_its_generator():
    """Same distributions as the JAX package, not the same bits: normal
    leaves with std 1/sqrt(fan-in) or the declared scale, zero biases, unit
    norms; one generator seed gives the same draw twice."""
    cfg = PSMOKES["qwen2.5-3b"].scaled(d_model=256, n_heads=8,
                                       n_kv_heads=2, d_ff=512)
    model = pbuild(cfg)
    a = model.init(torch.Generator().manual_seed(5), device="cpu")
    b = model.init(torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert sum(p.numel() for p in a.parameters()) == model.param_count()
    assert len(a["blocks"]) == cfg.n_layers
    blk = a["blocks"][0]
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    assert abs(float(blk["attn"]["wq"].std()) - 1 / math.sqrt(256)) < 0.01
    assert abs(float(blk["mlp"]["w_down"].std()) - 1 / math.sqrt(512)) \
        < 0.01
    assert not blk["attn"]["bq"].any() and bool((blk["ln1"] == 1).all())
    assert not any(p.requires_grad for p in a.parameters())


def test_init_params_draws_the_modules_numbers_in_the_jax_order():
    """The dict form and the module draw the same leaves from one
    generator in the same (sorted-path) order, stacked leaves whole."""
    cfg = PSMOKES["deepseek-v2-236b"]
    model = pbuild(cfg)
    tree = PC.init_params(model.defs, torch.Generator().manual_seed(3))
    module = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(tree["embed"], module["embed"])
    for i, blk in enumerate(module["blocks"]):
        assert torch.equal(tree["blocks"]["moe"]["w_up"][i],
                           blk["moe"]["w_up"])
        assert torch.equal(tree["blocks"]["attn"]["w_dkv"][i],
                           blk["attn"]["w_dkv"])
    assert torch.equal(tree["lm_head"], module["lm_head"])


def test_params_from_jax_refuses_a_wrong_shape():
    jcfg = JSMOKES["gemma-2b"]
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tree["final_ln"] = tree["final_ln"][:-1]
    with pytest.raises(ValueError, match="final_ln"):
        params_from_jax(PSMOKES["gemma-2b"], tree)
