"""The 3xTF32 arithmetic of the port's tensor-core kernels, on the CPU: the
split of fp32 values into TF32 big and small parts, the GEMM's and
attention's plain versions (which emulate the kernels' arithmetic, split-K
included) against the JAX package, the accuracy three passes buy over one,
and the build's hash over the shared header.

Tolerances, relative to max |reference|: GEMM 2e-4, attention 2e-3, those
of the JAX package's kernel tests.  The split reconstructs x to 2**-22
relative: big keeps 11 significant bits, small the next 11."""
import math
import shutil

import jax  # noqa: F401  (both frameworks load in every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.matmul.kernel import matmul as jax_matmul
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
from repro.kernels.registry import BENCHMARKS as JB
from repro_torch.kernels import common, tf32x3
from repro_torch.kernels.attention import kernel as A
from repro_torch.kernels.attention.space import AttentionInput
from repro_torch.kernels.matmul import kernel as K
from repro_torch.kernels.registry import BENCHMARKS as PB

GEMM_TOL = 2e-4
ATTENTION_TOL = 2e-3


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _tf32_reference(x: float) -> float:
    """TF32 rounding of one finite fp32 value from its exponent and
    mantissa, ties away from zero: an implementation independent of the bit
    trick under test."""
    if x == 0.0:
        return x
    mant, exp = math.frexp(abs(x))           # abs(x) = mant * 2**exp
    scaled = mant * 2.0 ** 11                # 11 significant bits
    r = math.floor(scaled + 0.5)             # half rounds up: away from 0
    return math.copysign(r * 2.0 ** (exp - 11), x)


# --- the split ----------------------------------------------------------------

def _values(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x *= (2.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    return torch.from_numpy(x)


def test_big_has_its_low_13_bits_zero():
    big, small = tf32x3.split(_values())
    assert not (_bits(big) & 0x1FFF).any()
    assert not (_bits(small) & 0x1FFF).any()


def test_big_plus_small_holds_x_to_2_pow_minus_22():
    x = _values()
    big, small = tf32x3.split(x)
    x64 = x.double()
    err = ((big.double() + small.double()) - x64).abs() / x64.abs()
    assert float(err.max()) <= 2.0 ** -22
    # one part alone is only good to 2**-11
    assert float(((big.double() - x64).abs() / x64.abs()).max()) <= 2.0 ** -11


def test_rounding_matches_an_independent_reference():
    x = _values(2048, seed=1)
    ours = tf32x3.round_tf32(x).double().numpy()
    ref = np.array([_tf32_reference(float(v)) for v in x.numpy()])
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_ties_round_away_from_zero(sign):
    # 1 + 2**-11 lies halfway between the TF32 values 1 and 1 + 2**-10
    # (low 13 bits exactly 0x1000); 1.5 + 2**-11 between 1.5 and 1.5 + 2**-10
    tie = torch.tensor([1.0 + 2.0 ** -11, 1.5 + 2.0 ** -11],
                       dtype=torch.float32) * sign
    assert (_bits(tie) & 0x1FFF == 0x1000).all()
    rounded = tf32x3.round_tf32(tie)
    assert torch.equal(rounded, torch.tensor(
        [1.0 + 2.0 ** -10, 1.5 + 2.0 ** -10], dtype=torch.float32) * sign)
    # just below the tie rounds towards zero
    below = torch.tensor([1.0 + 2.0 ** -11 - 2.0 ** -23],
                         dtype=torch.float32) * sign
    assert torch.equal(tf32x3.round_tf32(below),
                       torch.tensor([1.0], dtype=torch.float32) * sign)


# --- the GEMM's plain version against the JAX package ------------------------

def _gemm(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


GEMM_CASES = [
    ((128, 128, 128), (64, 128, 128, "mnk")),     # the registry's small input
    ((128, 128, 128), (128, 64, 256, "nmk")),
    ((16, 256, 2048), (64, 128, 128, "mnk")),     # split-K: M = 16
    ((100, 200, 300), (64, 64, 128, "nmk")),      # ragged, split-K
]


@pytest.mark.parametrize("shape,cfg", GEMM_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{c[2]}"
                              for s, c in GEMM_CASES])
def test_emulating_gemm_matches_pallas_and_oracle(shape, cfg):
    a, b = _gemm(*shape)
    bm, bn, bk, order = cfg
    kw = dict(block_m=bm, block_n=bn, block_k=bk, loop_order=order)
    ours = K.matmul_plain(torch.from_numpy(a), torch.from_numpy(b), **kw)
    pallas = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True, **kw)
    oracle = jax_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    assert _rel(ours.numpy(), pallas) < GEMM_TOL
    assert _rel(ours.numpy(), oracle) < GEMM_TOL


def test_the_skinny_case_splits_k_and_sums_in_split_order():
    m, n, k, bk = 16, 256, 2048, 128
    splits = K.split_count(m, n, k, 64, 128, bk, common.CPU_SMS)
    assert splits > 1
    a, b = (torch.from_numpy(x) for x in _gemm(m, n, k, seed=2))
    out = K.matmul_plain(a, b, block_m=64, block_n=128, block_k=bk)
    # the same sums, written out: each split's BLOCK_K steps, then the
    # partials in split order
    per = -(-(k // bk) // splits)
    parts = []
    for s in range(splits):
        acc = None
        for step in range(s * per, min(k // bk, (s + 1) * per)):
            ks = slice(step * bk, (step + 1) * bk)
            acc = tf32x3.product(tf32x3.split(a[:, ks]),
                                 tf32x3.split(b[ks]), acc)
        parts.append(acc)
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert torch.equal(out, want)


@pytest.mark.parametrize("m,n,k,block_k", [(16, 4096, 4096, 128),
                                           (16, 4096, 4096, 1024),
                                           (2048, 2048, 2048, 128),
                                           (4096, 16, 4096, 256),
                                           (100, 200, 300, 128)])
@pytest.mark.parametrize("block", [64, 128, 512])
def test_split_count_fills_one_wave_with_whole_steps(m, n, k, block, block_k):
    sms = 132
    tiles = -(-m // block) * -(-n // block)
    steps = -(-k // block_k)
    splits = K.split_count(m, n, k, block, block, block_k, sms)
    per = -(-steps // splits)
    assert 1 <= splits <= steps
    assert -(-steps // per) == splits          # no split is empty
    slots = sms * K.BLOCKS_PER_SM            # the blocks one wave holds
    if tiles * 2 > slots:
        assert splits == 1
        return
    # at most one wave: no more blocks than the card holds at once
    want = min(steps, slots // tiles)
    assert splits <= want and tiles * splits <= slots
    # and runs as short as whole steps allow: one step fewer a run would
    # need more splits than that
    assert per == 1 or -(-steps // (per - 1)) > want


@pytest.mark.parametrize("m,n,k", [(0, 4, 5), (3, 0, 5), (3, 4, 0)])
def test_empty_products_on_the_cpu(m, n, k):
    a, b = torch.ones((m, k)), torch.ones((k, n))
    out = K.matmul(a, b, block_m=64, block_n=64, block_k=128)
    assert out.shape == (m, n) and not bool(out.any())


def test_three_passes_are_ten_times_more_accurate_than_one():
    a, b = (torch.from_numpy(x) for x in _gemm(256, 256, 2048, seed=3))
    exact = a.double() @ b.double()
    three = K.matmul_plain(a, b, block_m=128, block_n=128, block_k=2048)
    one = tf32x3.round_tf32(a) @ tf32x3.round_tf32(b)
    err3, err1 = _rel(three.numpy(), exact.numpy()), _rel(one.numpy(),
                                                           exact.numpy())
    assert err3 < GEMM_TOL
    assert err3 * 10 <= err1


# --- attention's plain version against the JAX package -----------------------

@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (1, 2, 200, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
def test_emulating_attention_matches_pallas(shape, causal):
    inp = AttentionInput(*shape, causal=causal)
    ours = PB["attention"].make_args(inp, np.random.default_rng(0), "cpu")
    theirs = JB["attention"].make_args(inp, np.random.default_rng(0))
    out = A.flash_attention_plain(*ours, causal=causal)
    pallas = jax_flash_attention(*theirs, block_q=128, block_k=128,
                                 causal=causal, interpret=True)
    assert _rel(out.numpy(), pallas) < ATTENTION_TOL
    assert _rel(out.numpy(), JB["attention"].ref(*theirs,
                                                 causal=causal)) < ATTENTION_TOL


# --- the build ----------------------------------------------------------------

def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(common.CSRC_DIR, csrc)
    monkeypatch.setattr(common, "CSRC_DIR", csrc)
    before = {s: common.library_path(s) for s in ("matmul.cu", "attention.cu",
                                                  "nbody.cu")}
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: common.library_path(s) for s in before}
    assert all(before[s] != after[s] for s in before)
    assert all(p.name.startswith(s.split(".")[0] + "-")
               for s, p in after.items())


@pytest.mark.parametrize("source,symbol,args", [
    ("matmul.cu", "repro_matmul_f32", len(K._ARGTYPES)),
    ("mma_probe.cu", "repro_mma_tf32_probe", 4),
])
def test_c_entries_take_the_arguments_their_callers_pass(source, symbol,
                                                         args):
    """The GEMM's entry gained a workspace and a split count; the probe's
    entry is loaded by ``chip_smoke.py`` with four arguments."""
    text = (common.CSRC_DIR / source).read_text()
    assert f'extern "C" int {symbol}(' in text
    head = text.split(f"{symbol}(", 1)[1].split(")", 1)[0]
    assert len(head.split(",")) == args
    assert '#include "tf32x3.cuh"' in text or source == "mma_probe.cu"
