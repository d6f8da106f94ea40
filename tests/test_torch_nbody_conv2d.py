"""The redesigned nbody and conv2d wrappers on the CPU: nbody's j-split rule
and thread layout, the wrappers' argument checks, and their CPU path (the
plain versions, which ignore the parameters that only pick the CUDA code
path) against the JAX package at the shapes that take the new code paths on
the card (BLOCK_I below 128, W % 4 != 0).  The CUDA kernels themselves,
conv2d's 16-byte and 4-byte halo copies included, are tested on the card in
``test_torch_gpu.py``.

Tolerances, relative to max |reference|, are those of the JAX package's
kernel tests: nbody 1e-3, conv2d 1e-3 (the sums run in another order)."""
import jax  # noqa: F401  (both frameworks load in every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
from repro.kernels.nbody.kernel import nbody as jax_nbody
from repro.kernels.nbody.ref import nbody_ref as jax_nbody_ref
from repro_torch.kernels import common
from repro_torch.kernels.conv2d import kernel as CV
from repro_torch.kernels.nbody import kernel as NB
from repro_torch.kernels.nbody.space import NBodyInput
from repro_torch.kernels.registry import BENCHMARKS

NBODY_SPACE = BENCHMARKS["nbody"].make_space()
BLOCK_IS = NBODY_SPACE.parameters[0].values
BLOCK_JS = NBODY_SPACE.parameters[1].values
NBODY_NS = [200, 10000, 16384, 131072]


def _split_ranges(n, block_i, block_j, sms):
    """The j bodies [begin, end) of each run, as the kernel cuts them:
    runs of cdiv(tiles, splits) whole tiles, the last ending at n."""
    splits = NB.split_count(n, block_i, block_j, sms)
    per = -(-(-(-n // block_j)) // splits) * block_j
    return [(s * per, min(n, (s + 1) * per)) for s in range(splits)]


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


# --- nbody: thread layout and the j-split -------------------------------------

@pytest.mark.parametrize("block_i", BLOCK_IS)
def test_blocks_are_whole_warps_and_lanes_share_tiles_evenly(block_i):
    threads = NB.block_threads(block_i)
    lanes = NB.j_lanes(block_i)
    groups = block_i // NB.BODIES_PER_THREAD
    assert threads % 32 == 0 and threads >= 32
    assert groups * lanes == threads
    assert lanes == (1 if block_i >= 128 else 128 // block_i)
    assert all(bj % lanes == 0 for bj in BLOCK_JS)


@pytest.mark.parametrize("n", NBODY_NS)
@pytest.mark.parametrize("block_j", BLOCK_JS)
@pytest.mark.parametrize("block_i", BLOCK_IS)
def test_split_ranges_cover_every_tile_once(n, block_i, block_j):
    sms = common.CPU_SMS
    ranges = _split_ranges(n, block_i, block_j, sms)
    # in order, back to back, from 0 to n, none empty, whole tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(b < e and b % block_j == 0 for b, e in ranges)
    tiles = [t for b, e in ranges for t in range(b // block_j,
                                                  -(-e // block_j))]
    assert tiles == list(range(-(-n // block_j)))
    # the same answer every time
    assert _split_ranges(n, block_i, block_j, sms) == ranges


@pytest.mark.parametrize("n", NBODY_NS)
@pytest.mark.parametrize("block_i", BLOCK_IS)
def test_split_is_one_when_the_blocks_alone_make_the_waves(n, block_i):
    sms = common.CPU_SMS
    warps = -(-n // block_i) * NB.block_threads(block_i) // 32
    target = sms * NB.RESIDENT_WARPS_PER_SM * NB.SPLIT_WAVES
    for block_j in BLOCK_JS:
        splits = NB.split_count(n, block_i, block_j, sms)
        if warps * 2 > target:
            assert splits == 1
        else:
            # never more blocks than the target asks for, and runs as short
            # as whole tiles allow
            tiles = -(-n // block_j)
            want = min(tiles, target // warps)
            per = -(-tiles // splits)
            assert splits <= want and warps * splits <= target
            assert per == 1 or -(-tiles // (per - 1)) > want


def test_the_split_fills_the_card_at_16384_and_not_at_131072_block_8():
    sms = common.CPU_SMS
    assert NB.split_count(16384, 1024, 512, sms) == 32
    assert NB.split_count(16384, 128, 256, sms) > 1
    assert NB.split_count(131072, 8, 2048, sms) == 1


@pytest.mark.parametrize("n", [16384, 131072])
def test_the_workspace_stays_small_over_the_space(n):
    """The wrapper's workspace holds splits x N x 4 fp32: at most 64 MiB
    anywhere in the space at the registry's sizes."""
    for cfg in NBODY_SPACE:
        splits = NB.split_count(n, cfg["BLOCK_I"], cfg["BLOCK_J"],
                                common.CPU_SMS)
        assert splits * n * 16 <= 64 * 2**20, cfg


def test_sm_count_is_the_h100s_on_the_cpu():
    assert common.sm_count(torch.device("cpu")) == 132


def test_issue_floor_counts_twelve_instructions_a_pair():
    # 12 x 16384^2 at one instruction a lane a clock on 128 x 132 lanes
    floor = NB.issue_floor_ms(16384, 67e12)
    assert floor == pytest.approx(12 * 16384**2 / 33.5e12 * 1e3)
    assert 0.09 < floor < 0.1
    assert NB.issue_floor_ms(131072, 67e12) == pytest.approx(64 * floor)


# --- the wrappers' new argument checks --------------------------------------

def _bad_calls():
    bodies, img, flt = torch.zeros((16, 4)), torch.zeros((8, 8)), \
        torch.zeros((5, 5))
    return [
        ("nbody-block-i-not-a-power-of-two",
         lambda: NB.nbody(bodies, block_i=24)),
        ("nbody-block-i-below-one-group", lambda: NB.nbody(bodies, block_i=2)),
        ("nbody-block-j-not-whole-lanes",       # BLOCK_I 8: 16 lanes
         lambda: NB.nbody(bodies, block_i=8, block_j=40)),
        ("conv2d-depth-0", lambda: CV.conv2d(img, flt, dma_depth=0)),
        ("conv2d-depth-5", lambda: CV.conv2d(img, flt, dma_depth=5)),
    ]


@pytest.mark.parametrize("idx", range(5), ids=[c[0] for c in _bad_calls()])
def test_new_argument_checks(idx):
    _, call = _bad_calls()[idx]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("block_i", [4, 8, 16, 32, 64, 1024])
def test_every_power_of_two_block_i_is_taken(block_i):
    bodies = BENCHMARKS["nbody"].make_args(NBodyInput(40),
                                           np.random.default_rng(0), "cpu")[0]
    out = NB.nbody(bodies, block_i=block_i, block_j=32)
    assert out.shape == (40, 4)


# --- the CPU path against the JAX package at the new code paths -------------

@pytest.mark.parametrize("block_i,block_j", [(8, 32), (16, 64), (64, 128)])
def test_cpu_nbody_small_blocks_match_pallas_and_oracle(block_i, block_j):
    """The CPU path (``nbody_plain``) at the block sizes that take j lanes
    on the card, against the Pallas kernel in interpret mode."""
    b = BENCHMARKS["nbody"].make_args(NBodyInput(96),
                                      np.random.default_rng(3), "cpu")[0]
    theirs = jnp.asarray(b.numpy())
    pallas = jax_nbody(theirs, block_i=block_i, block_j=block_j,
                       interpret=True)
    oracle = jax_nbody_ref(theirs)
    out = NB.nbody(b, block_i=block_i, block_j=block_j)
    assert _rel(out.numpy(), pallas) < 1e-3
    assert _rel(out.numpy(), oracle) < 1e-3


@pytest.mark.parametrize("h,w,f", [(37, 301, 3), (40, 61, 5), (21, 18, 7),
                                   (13, 27, 1), (20, 33, 9)])
def test_cpu_conv2d_ragged_widths_match_the_jax_oracle(h, w, f):
    """The CPU path (``conv2d_plain``) at widths whose rows take 4-byte
    halo copies on the card, and at a looped-tap F."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((h, w), dtype=np.float32)
    flt = rng.standard_normal((f, f), dtype=np.float32)
    oracle = jax_conv2d_ref(jnp.asarray(img), jnp.asarray(flt))
    out = CV.conv2d(torch.from_numpy(img), torch.from_numpy(flt), by=32,
                    bx=128, unroll_taps=int(f in CV.UNROLLED_F))
    assert out.shape == (h, w)
    assert _rel(out.numpy(), oracle) < 1e-3
