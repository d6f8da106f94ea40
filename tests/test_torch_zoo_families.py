"""The port's ssm, xlstm, hybrid and encoder-decoder modules against their
JAX counterparts, function by function, on the CPU.

Each module's function gets the same inputs, made from a numpy seed, and
the JAX parameters carried across: Mamba2's chunked form (one chunk and
several), its final state and its decode step, with a decay that
overflows above the diagonal; mLSTM and sLSTM, chunked and step by step,
with their final states; GQA prefill with ``causal=False`` (the encoder's
self-attention, through the kernel's wrapper, whose plain version runs on
CPU tensors); the chunked cross-attention with a key length of its own;
each new SMOKE arch in bf16; the chunk rule both packages share; and the
kernel routes the models take.

Tolerance, fp32: max |port - JAX| <= 1e-4 x max |JAX| (the sums run in
another order, about 1e-6 here).  bf16: 5e-2 x max |JAX|, as for the
transformer families (tests/test_torch_models.py): a bf16 ulp is 2**-8 of
a value, and the JAX package rounds q·scale and p to bf16 inside its
attention where the port's kernel keeps fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import hybrid as JH
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.models.registry import build_model as jbuild
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.kernels.attention import kernel as K
from repro_torch.models import attention as PA
from repro_torch.models import ssm as PS
from repro_torch.models import xlstm as PX
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as pbuild

RTOL = 1e-4
BF16_RTOL = 5e-2
NEW_ARCHS = ["zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]


def _rel(port, ref) -> float:
    a = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    b = port.double().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _params(defs, seed, randomize=()):
    """JAX params of ``defs``; the leaves named in ``randomize`` redrawn
    from a normal (their init is zeros or ones), so that they matter."""
    p = JC.init_params(jax.random.PRNGKey(seed), defs)
    rng = np.random.default_rng(seed)
    for name, scale, shift in randomize:
        p[name] = jnp.asarray((shift + scale * rng.standard_normal(
            p[name].shape)).astype(np.float32))
    return p


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _assert_cache(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert tuple(port[k].shape) == v.shape, k
        if k == "pos":
            assert port[k].tolist() == np.asarray(v).tolist()
        else:
            assert _rel(port[k], v) <= RTOL, k


# --- Mamba2 ------------------------------------------------------------------

MAMBA = dict(d_model=32, d_state=8, head_dim=8, chunk=16)
MAMBA_RANDOM = (("a_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                ("conv_b", 0.1, 0.0), ("d_skip", 0.5, 1.0))


@pytest.mark.parametrize("s", [12, 48], ids=["one_chunk", "three_chunks"])
def test_mamba2_chunked_form_and_final_state_match_jax(s):
    jcfg, pcfg = JS.Mamba2Config(**MAMBA), PS.Mamba2Config(**MAMBA)
    jp = _params(JS.mamba2_defs(jcfg), 0, MAMBA_RANDOM)
    x = _x(2, s, 32)
    ref, _ = JS.mamba2_apply(jp, jcfg, jnp.asarray(x))
    got, state = PS.mamba2_apply(_tree(jp), pcfg, _t(x), with_state=True)
    assert got.shape == (2, s, 32)
    assert _rel(got, ref) <= RTOL
    plain, none = PS.mamba2_apply(_tree(jp), pcfg, _t(x))
    assert none is None and torch.equal(plain, got)
    _assert_cache(state, JH._mamba_state_from_prefix(jp, jcfg,
                                                     jnp.asarray(x)))


def test_mamba2_decode_steps_match_jax():
    """Three recurrent steps from a prefix's state, the cache carried on
    each side."""
    jcfg, pcfg = JS.Mamba2Config(**MAMBA), PS.Mamba2Config(**MAMBA)
    jp = _params(JS.mamba2_defs(jcfg), 1, MAMBA_RANDOM)
    pp = _tree(jp)
    x = _x(2, 16 + 3, 32, seed=1)
    jc = JH._mamba_state_from_prefix(jp, jcfg, jnp.asarray(x[:, :16]))
    _, pc = PS.mamba2_apply(pp, pcfg, _t(x[:, :16]), with_state=True)
    for t in range(16, 19):
        ref, jc = JS.mamba2_apply(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                  cache=jc)
        got, pc = PS.mamba2_apply(pp, pcfg, _t(x[:, t:t + 1]), cache=pc)
        assert _rel(got, ref) <= RTOL, t
        _assert_cache(pc, jc)


def test_mamba2_init_cache_matches_jax():
    jcfg, pcfg = JS.Mamba2Config(**MAMBA), PS.Mamba2Config(**MAMBA)
    ref = JS.mamba2_init_cache(jcfg, 3, jnp.float32)
    got = PS.mamba2_init_cache(pcfg, 3, torch.float32)
    _assert_cache(got, ref)
    assert got["h"].dtype == torch.float32


def test_mamba2_masked_decay_overflow_never_reaches_the_output():
    """Fast decays (A = -e^3, dt near 5): exp(cum_t - cum_s) is inf above
    the diagonal; masked after the product, as in JAX, the output stays
    finite and equal to JAX's."""
    jcfg, pcfg = JS.Mamba2Config(**MAMBA), PS.Mamba2Config(**MAMBA)
    jp = _params(JS.mamba2_defs(jcfg), 2, (("a_log", 0.0, 3.0),
                                           ("dt_bias", 0.0, 5.0)))
    x = _x(1, 32, 32, seed=2)
    cum = np.cumsum(5.0 * -np.exp(3.0) * np.ones(16))
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[0] - cum[-1]))   # the unmasked decay
    ref, _ = JS.mamba2_apply(jp, jcfg, jnp.asarray(x))
    got, _ = PS.mamba2_apply(_tree(jp), pcfg, _t(x))
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= RTOL


# --- xLSTM -------------------------------------------------------------------

XL = dict(d_model=32, n_heads=2, chunk=16)


@pytest.mark.parametrize("s", [12, 48], ids=["one_chunk", "three_chunks"])
def test_mlstm_chunked_form_and_final_state_match_jax(s):
    jcfg, pcfg = JX.XLSTMConfig(**XL), PX.XLSTMConfig(**XL)
    jp = _params(JX.mlstm_defs(jcfg), 3, (("b_if", 2.0, 0.0),))
    x = _x(2, s, 32, seed=3)
    ref, _ = JX.mlstm_apply(jp, jcfg, jnp.asarray(x))
    got, state = PX.mlstm_apply(_tree(jp), pcfg, _t(x), with_state=True)
    assert _rel(got, ref) <= RTOL
    _assert_cache(state, JH._mlstm_state_from_prefix(jp, jcfg,
                                                     jnp.asarray(x)))


def test_mlstm_decode_steps_match_jax():
    jcfg, pcfg = JX.XLSTMConfig(**XL), PX.XLSTMConfig(**XL)
    jp = _params(JX.mlstm_defs(jcfg), 4, (("b_if", 2.0, 0.0),))
    pp = _tree(jp)
    x = _x(2, 19, 32, seed=4)
    jc = JH._mlstm_state_from_prefix(jp, jcfg, jnp.asarray(x[:, :16]))
    _, pc = PX.mlstm_apply(pp, pcfg, _t(x[:, :16]), with_state=True)
    for t in range(16, 19):
        ref, jc = JX.mlstm_apply(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                 cache=jc)
        got, pc = PX.mlstm_apply(pp, pcfg, _t(x[:, t:t + 1]), cache=pc)
        assert _rel(got, ref) <= RTOL, t
        _assert_cache(pc, jc)


@pytest.mark.parametrize("s", [12, 48], ids=["one_chunk", "three_chunks"])
def test_slstm_whole_sequence_and_final_state_match_jax(s):
    """``slstm_apply`` (JAX: scanned a chunk at a time) and the prefill's
    ``_slstm_full_with_state`` (JAX: one scan) give one output."""
    jcfg, pcfg = JX.XLSTMConfig(**XL), PX.XLSTMConfig(**XL)
    jp = _params(JX.slstm_defs(jcfg), 5, (("b", 1.0, 0.0),))
    x = _x(2, s, 32, seed=5)
    ref, _ = JX.slstm_apply(jp, jcfg, jnp.asarray(x))
    got, none = PX.slstm_apply(_tree(jp), pcfg, _t(x))
    assert none is None and _rel(got, ref) <= RTOL
    jy, jc = JH._slstm_full_with_state(jp, jcfg, jnp.asarray(x))
    py, pc = PX.slstm_apply(_tree(jp), pcfg, _t(x), with_state=True)
    assert _rel(py, jy) <= RTOL
    _assert_cache(pc, jc)


def test_slstm_decode_steps_and_init_caches_match_jax():
    jcfg, pcfg = JX.XLSTMConfig(**XL), PX.XLSTMConfig(**XL)
    jp = _params(JX.slstm_defs(jcfg), 6, (("b", 1.0, 0.0),))
    pp = _tree(jp)
    jc, pc = JX.slstm_init_cache(jcfg, 2), PX.slstm_init_cache(pcfg, 2)
    _assert_cache(pc, jc)
    _assert_cache(PX.mlstm_init_cache(pcfg, 2), JX.mlstm_init_cache(jcfg, 2))
    x = _x(2, 4, 32, seed=6)
    for t in range(4):
        ref, jc = JX.slstm_apply(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                 cache=jc)
        got, pc = PX.slstm_apply(pp, pcfg, _t(x[:, t:t + 1]), cache=pc)
        assert _rel(got, ref) <= RTOL, t
        _assert_cache(pc, jc)


# --- attention: the encoder's and the cross-attention -----------------------

@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("s", [40, 50], ids=["s_multiple_of_chunk", "s_not"])
def test_non_causal_gqa_prefill_matches_jax(s, hkv, monkeypatch):
    """The encoder's self-attention: RoPE, then every key for every query,
    through the kernel's wrapper (one plain call, not causal); JAX over
    kv chunks of 20, so that it takes several and a short last one."""
    calls = []
    plain = K.flash_attention_plain

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return plain(*a, **kw)

    monkeypatch.setattr(K, "flash_attention_plain", spy)
    jcfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=hkv, head_dim=8,
                         causal=False, rope_theta=1e4)
    pcfg = PA.AttnConfig(**jcfg._asdict())
    jp = _params(JA.gqa_defs(jcfg), 7)
    x = _x(2, s, 32, seed=7)
    ref, _ = JA.gqa_apply(jp, jcfg, jnp.asarray(x), kv_chunk=20)
    got, kv = PA.gqa_apply(_tree(jp), pcfg, _t(x))
    assert calls == [False]
    assert _rel(got, ref) <= RTOL
    assert kv["k"].shape == (2, s, hkv, 8)
    causal, _ = PA.gqa_apply(_tree(jp), pcfg._replace(causal=True), _t(x))
    assert _rel(causal, ref) > 1e-2       # the mask matters at these inputs


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("t", [8, 37, 64], ids=["t8", "t37", "t64"])
def test_chunked_cross_attention_matches_jax(t, hkv):
    """Queries (S = 5) over keys of another length, in chunks of 16: a
    short last chunk (37), an exact multiple (64) and one chunk (8)."""
    rng = np.random.default_rng(t * 10 + hkv)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, hkv, 6)).astype(np.float32)
    ref = JA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), False, chunk=16)
    got = PA.chunked_attention(_t(q), _t(k), _t(v), chunk=16)
    assert got.shape == (2, 5, 4, 6) and got.dtype == torch.float32
    assert _rel(got, ref) <= RTOL


def test_chunked_cross_attention_in_bf16_rounds_as_jax():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 3, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    ref = JA._chunked_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), False, chunk=16)
    got = PA.chunked_attention(*(_t(a).to(torch.bfloat16)
                                 for a in (q, k, v)), chunk=16)
    assert _rel(got, ref) <= 1e-2


# --- whole archs: bf16, the chunk rule, the kernel's routes ------------------

def _arch_inputs(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(2, s))
             .astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def _both(arch, dtype="float32"):
    jcfg = dataclasses.replace(JSMOKES[arch], dtype=dtype)
    pcfg = PSMOKES[arch].scaled(dtype=dtype)
    jm, pm = jbuild(jcfg), pbuild(pcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, pm, params_from_jax(pcfg, jax.tree.map(np.asarray, jp))


def _flat(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_bf16_prefill_matches_jax_within_its_own_tolerance(arch):
    """Prefill logits and every floating cache leaf; the cache keeps the
    JAX dtypes (states fp32, K/V and the conv tail bf16); the greedy first
    tokens agree."""
    jm, jp, pm, pp = _both(arch, "bfloat16")
    batch = _arch_inputs(pm.cfg, 11)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        max_seq=24)
    pl, pc = pm.prefill(pp, {k: _t(v) for k, v in batch.items()}, 24)
    assert pl.dtype == torch.bfloat16
    assert _rel(pl.float(), jl) <= BF16_RTOL
    assert (pl.float().numpy()[:, -1].argmax(-1)
            == np.asarray(jl.astype(jnp.float32))[:, -1].argmax(-1)).all()
    jc, pc = _flat(jc), _flat(pc)
    assert set(pc) == set(jc)
    for k, v in jc.items():
        assert str(pc[k].dtype).split(".")[-1] == str(v.dtype), k
        if not k.endswith("pos"):
            assert _rel(pc[k].float(), v) <= BF16_RTOL, k


@pytest.mark.parametrize("s", [96, 200, 256])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_both_packages_take_the_same_prefill_lengths(arch, s):
    """The chunked scans take a prompt of at most one chunk (128) or a
    multiple of it: 96 and 256 pass on both packages, 200 fails on both,
    the JAX package with an AssertionError, the port with a ValueError
    naming that assert (ROADMAP.md, queue 3)."""
    jm, jp, pm, pp = _both(arch)
    batch = _arch_inputs(pm.cfg, s, seed=s)
    if s == 200:
        with pytest.raises(AssertionError):
            jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       max_seq=s)
        with pytest.raises(ValueError, match="src/repro/models/"):
            pm.prefill(pp, {k: _t(v) for k, v in batch.items()}, s)
        return
    jl, _ = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       max_seq=s)
    pl, _ = pm.prefill(pp, {k: _t(v) for k, v in batch.items()}, s)
    assert _rel(pl, jl) <= RTOL


@pytest.mark.parametrize("arch,expected", [
    ("zamba2-2.7b", [True, True]),                     # one a superblock
    ("xlstm-125m", []),
    ("seamless-m4t-large-v2", [False, False, True, True]),  # enc, then dec
])
def test_prefill_attention_takes_the_kernels_wrapper(arch, expected,
                                                     monkeypatch):
    """Every prefill self-attention reaches the kernel's wrapper (its
    plain version on CPU tensors), causal or not as the arch says; the
    cross-attention never does."""
    calls = []
    plain = K.flash_attention_plain

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw.get("causal")))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(K, "flash_attention_plain", spy)
    cfg = PSMOKES[arch]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: _t(v) for k, v in _arch_inputs(cfg, 9).items()}
    model.prefill(params, batch, 16)
    assert [c for _, c in calls] == expected
    hd = cfg.eff_head_dim
    for shape, causal in calls:
        s = 9 if causal else cfg.frontend_len
        assert shape == (2, cfg.n_heads, s, hd)


def test_zamba2_params_nest_superblocks_of_layers():
    """``supers`` is a ModuleList of superblocks, each a ModuleList of its
    Mamba2 layers, holding the JAX (n_super, per) stack leaf by leaf."""
    jm, jp, pm, pp = _both("zamba2-2.7b")
    cfg = pm.cfg
    n_super = cfg.n_layers // cfg.mamba_per_attn
    assert len(pp["supers"]) == n_super
    assert all(len(sb) == cfg.mamba_per_attn for sb in pp["supers"])
    for i in range(n_super):
        for j in range(cfg.mamba_per_attn):
            assert np.array_equal(
                pp["supers"][i][j]["mamba"]["w_in"].numpy(),
                np.asarray(jp["supers"]["mamba"]["w_in"][i, j]))
    assert sum(p.numel() for p in pp.parameters()) == pm.param_count()
    drawn = pm.init(torch.Generator().manual_seed(0), device="cpu")
    assert [n for n, _ in drawn.named_parameters()] \
        == [n for n, _ in pp.named_parameters()]


@pytest.mark.parametrize("arch,path", [
    ("zamba2-2.7b", ("supers", "mamba", "conv_w")),
    ("zamba2-2.7b", ("shared", "attn", "wq")),
    ("xlstm-125m", ("pairs", "slstm", "w_r")),
    ("seamless-m4t-large-v2", ("dec", "xattn", "wk")),
    ("seamless-m4t-large-v2", ("frontend_proj",)),
])
def test_params_from_jax_refuses_a_wrong_shape_in_the_new_trees(arch, path):
    jp = jbuild(JSMOKES[arch]).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = node[path[-1]][..., :-1]
    with pytest.raises(ValueError, match=path[-1]):
        params_from_jax(PSMOKES[arch], tree)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_the_engine_serves_the_recurrent_archs_as_their_greedy_loop(arch):
    """``ServeEngine`` on the CPU: a wave's tokens are those of a greedy
    loop over ``prefill`` and ``decode`` on the left-padded prompts."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = PSMOKES[arch]
    model = pbuild(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=5)
            for i, n in enumerate((7, 12))]
    out = ServeEngine(model, batch_size=2, max_seq=32, params=params,
                      device="cpu").generate(reqs)
    toks = np.zeros((2, 12), np.int32)
    for i, r in enumerate(reqs):
        toks[i, 12 - len(r.prompt):] = r.prompt
    logits, cache = model.prefill(params, {"tokens": _t(toks)}, 32)
    want = [[], []]
    for _ in range(5):
        tok = logits[:, -1].argmax(-1)
        for i in range(2):
            want[i].append(int(tok[i]))
        logits, cache = model.decode(params, cache, {"tokens": tok[:, None]})
    assert out == {0: want[0], 1: want[1]}
