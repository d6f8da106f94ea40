"""DeepSeek-V2's latent attention (MLA) on the port's attention kernel, on
the CPU: the wrapper at a V head dim below the qk dim (its plain version)
against softmax·V in float64, ``mla_apply``'s prefill through
``kernel_attention`` against the plain reference layer
(``tests/_torch_mla_reference.py``), ``KernelAttention``'s gradient at
Dv < D, the workload model at Dv, the C entry's (D, Dv) pairs and the
split-V launch count.  The kernel's own tests at (192, 128) are in
``test_torch_gpu.py``.

Tolerances, relative to max |reference|: the wrapper 1e-5 against float64
(3xTF32 products emulated in fp32 and fp32 sums over at most 67 keys; a
TF32 product would miss it by about 1e-3); the layer 1e-5 against the
float32 reference (the same products, summed in another order)."""
import re

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch

import _torch_mla_reference as R
from repro_torch.configs import SMOKES
from repro_torch.kernels import common
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention import space as S
from repro_torch.kernels.registry import BENCHMARKS
from repro_torch.models import attention as MA
from repro_torch.models.common import init_params
from repro_torch.models.transformer import attn_config

TOL = 1e-5


def _rel(out, ref) -> float:
    out, ref = out.detach().double(), ref.detach().double()
    return float((out - ref).abs().max() / ref.abs().max())


def _qkv(shape, dv, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k = (0.3 * torch.randn(shape, generator=g) for _ in range(2))
    v = 0.3 * torch.randn(shape[:3] + (dv,), generator=g)
    return q, k, v


def _softmax_v(q, k, v, causal):
    """softmax(q kᵀ / √D) v in float64, (B, H, S, Dv)."""
    q, k, v = q.double(), k.double(), v.double()
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        n = q.shape[2]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.softmax(s, dim=-1) @ v


# --- the wrapper at Dv < D ---------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,dv", [((2, 3, 67, 24), 16),
                                      ((1, 2, 40, 192), 128)],
                         ids=["24-16", "192-128"])
def test_flash_attention_takes_a_narrower_v(shape, dv, causal):
    q, k, v = _qkv(shape, dv)
    out = K.flash_attention(q, k, v, causal=causal, block_q=128, block_k=256)
    assert out.shape == shape[:3] + (dv,) and out.is_contiguous()
    assert _rel(out, _softmax_v(q, k, v, causal)) < TOL
    plain = K.flash_attention_plain(q, k, v, causal=causal)
    assert plain.shape == out.shape
    assert _rel(plain, _softmax_v(q, k, v, causal)) < TOL


@pytest.mark.parametrize("d,dv,padded", [
    (192, 128, (192, 128)), (192, 100, (192, 128)), (192, 129, (192, 192)),
    (160, 128, (192, 128)), (128, 64, (128, 128)), (24, 16, (32, 32)),
    (256, 128, (256, 256))])
def test_head_dims_pad_to_a_compiled_pair(d, dv, padded):
    dp = K.padded_head_dim(d)
    assert (dp, K.padded_value_dim(dp, dv)) == padded


def test_split_v_pairs_are_the_c_entrys():
    text = (common.CSRC_DIR / K.SOURCE).read_text()
    pairs = tuple((int(a), int(b)) for a, b in re.findall(
        r"^\s*REPRO_ATTENTION_SPLIT_V\((\d+), (\d+)\)", text, re.M))
    assert pairs == K.SPLIT_V_DIMS == ((192, 128),)
    assert all(d in K.HEAD_DIMS and dv % 8 == 0 and dv < d
               for d, dv in pairs)


@pytest.mark.parametrize("dv", [0, 25])
def test_a_v_wider_than_q_or_empty_is_refused(dv):
    q, k, v = _qkv((1, 2, 16, 24), max(dv, 1))
    with pytest.raises(ValueError, match="V's head dim"):
        K.flash_attention(q, k, v[..., :dv].contiguous())


# --- the launch and its counts -----------------------------------------------

@pytest.mark.parametrize("d,dv,split", [(192, 128, 1), (192, 192, 0),
                                        (64, 64, 0)])
def test_a_launch_passes_its_pair_and_counts_a_split_v(monkeypatch, d, dv,
                                                       split):
    """The operator's CUDA body, with the C entry replaced by a recorder:
    the pair (D, Dv) goes to the entry, the output is (B, H, S, Dv), and
    a split instance counts in ``split_v_launches`` beside ``launches``."""
    seen = []
    monkeypatch.setattr(K, "_entry", lambda: "entry")
    monkeypatch.setattr(K, "launch", lambda fn, device, *a: seen.append(a)
                        or 0)
    monkeypatch.setattr(K.flash_attention, "launches", 0)
    monkeypatch.setattr(K.flash_attention, "split_v_launches", 0)
    q, k, v = _qkv((1, 2, 64, d), dv)
    out = K._launch_kernel(q, k, v, 128, 128, 1, 1, True, 0.1)
    assert out.shape == (1, 2, 64, dv)
    assert seen[0][4:8] == (2, 64, d, dv)
    assert K.flash_attention.launches == 1
    assert K.flash_attention.split_v_launches == split


def test_the_cpu_path_counts_no_launch():
    before = (K.flash_attention.launches, K.flash_attention.split_v_launches)
    K.flash_attention(*_qkv((1, 2, 32, 192), 128))
    assert (K.flash_attention.launches,
            K.flash_attention.split_v_launches) == before


def test_the_fake_output_has_vs_head_dim():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = _qkv((1, 2, 64, 192), 128)
        out = K.flash_attention(q, k, v)
    assert out.shape == (1, 2, 64, 128)
    assert K.attention_flops((1, 2, 64, 192), True, 128) == \
        2.0 * 2 * (192 + 128) * 64 * 65 / 2
    assert K.attention_flops((1, 2, 64, 192), True) == \
        K.attention_flops((1, 2, 64, 192), True, 192)


# --- the workload model ------------------------------------------------------

SPACE = BENCHMARKS["attention"].make_space()


@pytest.mark.parametrize("causal", [True, False])
def test_workload_fn_is_unchanged_with_v_head_dim_unset(causal):
    unset = S.AttentionInput(1, 16, 2048, 192, causal=causal)
    same = S.AttentionInput(1, 16, 2048, 192, causal=causal, v_head_dim=192)
    assert unset.tag == "b1h16s2048d192"
    assert same.tag == "b1h16s2048d192v192"
    for cfg in SPACE:
        assert S.workload_fn(cfg, unset) == S.workload_fn(cfg, same)


def test_workload_fn_prices_pv_and_vs_bytes_at_dv():
    d, dv = 192, 128
    wide = S.AttentionInput(1, 16, 2048, d)
    mla = S.AttentionInput(1, 16, 2048, d, v_head_dim=dv)
    for cfg in SPACE:
        a, b = S.workload_fn(cfg, wide), S.workload_fn(cfg, mla)
        # QKᵀ at D and PV at Dv: (D + Dv) / 2D of the square's products
        assert b["FP32_FLOPS"] == pytest.approx(a["FP32_FLOPS"]
                                                * (d + dv) / (2 * d))
        assert b["DRAM_WR"] == pytest.approx(a["DRAM_WR"] * dv / d)
        assert b["DRAM_RD"] < a["DRAM_RD"] and b["SMEM_WS"] < a["SMEM_WS"]
        for key in ("SFU_OPS", "INT_OPS", "CTAS"):
            assert b[key] == a[key]
    # one tile a head: q read at D, K and V at D and Dv (1.5 times, as the
    # JAX model prices its diagonal tiles), 2 bytes an element
    one = {"BLOCK_Q": 2048, "BLOCK_K": 2048, "KEEP_P": 1, "Q_PREFETCH": 1}
    inp = S.AttentionInput(1, 1, 2048, d, causal=False, v_head_dim=dv)
    assert S.workload_fn(one, inp)["DRAM_RD"] == \
        2048 * (d + 1.5 * (d + dv)) * 2


def test_make_args_draws_v_at_its_head_dim():
    inp = S.AttentionInput(1, 2, 40, 192, v_head_dim=128)
    q, k, v = BENCHMARKS["attention"].make_args(
        inp, np.random.default_rng(0), "cpu")
    assert q.shape == k.shape == (1, 2, 40, 192)
    assert v.shape == (1, 2, 40, 128)
    ref = BENCHMARKS["attention"].ref(q, k, v)
    assert _rel(BENCHMARKS["attention"].run(SPACE[0], q, k, v), ref) < 1e-5


# --- the layer ---------------------------------------------------------------

ARCH = SMOKES["deepseek-v2-236b"]
ACFG = attn_config(ARCH)


def _layer(seed=0, b=2, s=37):
    g = torch.Generator().manual_seed(seed)
    params = init_params(MA.mla_defs(ACFG), g)
    x = torch.randn((b, s, ACFG.d_model), generator=g)
    return params, x


def _reference(params, x):
    return R.mla_prefill(params, x, n_heads=ACFG.n_heads,
                         nope_dim=ACFG.head_dim, rope_dim=ACFG.qk_rope_dim,
                         v_dim=ACFG.v_head_dim, rope_theta=ACFG.rope_theta)


def test_smoke_arch_has_qk_24_and_v_16():
    assert (ACFG.head_dim + ACFG.qk_rope_dim, ACFG.v_head_dim) == (24, 16)


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_prefill_runs_the_kernel_and_meets_the_reference(monkeypatch,
                                                             seed):
    calls = []

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return K.flash_attention(q, k, v, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the plain attention ran on the forward path")

    monkeypatch.setattr(MA, "flash_attention", counted)
    monkeypatch.setattr(MA, "plain_causal_attention", refuse)
    params, x = _layer(seed)
    y, cache = MA.mla_apply(params, ACFG, x)
    b, s = x.shape[:2]
    assert calls == [((b, ACFG.n_heads, s, 24), (b, ACFG.n_heads, s, 16))]
    assert y.shape == x.shape
    assert set(cache) == {"c_kv", "k_rope"}
    assert _rel(y, _reference(params, x)) < TOL


def test_the_reference_layer_is_the_plain_model_layer():
    """Before the kernel took it: the plain attention in the model's place
    gives the reference's output too."""
    params, x = _layer(2)
    import unittest.mock as mock

    with mock.patch.object(MA, "kernel_attention",
                           lambda q, k, v, causal, chunk:
                           MA.plain_causal_attention(q, k, v, chunk)):
        y, _ = MA.mla_apply(params, ACFG, x)
    assert _rel(y, _reference(params, x)) < TOL


def test_kernel_attention_gradient_at_a_narrower_v():
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn((2, 19, 3, 24), generator=g).requires_grad_()
            for _ in range(2))
    v = torch.randn((2, 19, 3, 16), generator=g).requires_grad_()
    w = torch.randn((2, 19, 3, 16), generator=g)
    out = MA.kernel_attention(q, k, v, causal=True, chunk=8)
    assert out.shape == (2, 19, 3, 16)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref = MA.plain_causal_attention(q, k, v, chunk=8)
    assert _rel(out, ref) < TOL
    ref_grads = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for a, b in zip(grads, ref_grads):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-6
