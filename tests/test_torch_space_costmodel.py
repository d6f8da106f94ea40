"""The port's GEMM spaces, workload model and cost model against the JAX
package's, number for number under ``counters.TPU_NAMES``.

The TPU specs are converted field by field at test time, so both cost
models run on identical numbers; no TPU figure lives in the port."""
import dataclasses

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import costmodel as jcost
from repro.core import hwspec as jhw
from repro.kernels.matmul import space as jspace
from repro_torch.core import costmodel as pcost
from repro_torch.core import counters as PC
from repro_torch.core import hwspec as phw
from repro_torch.kernels.matmul import space as pspace

# JAX HardwareSpec field -> port HardwareSpec field
FIELD_MAP = {
    "name": "name", "generation": "generation",
    "mxu_flops": "fp32_flops", "vpu_flops": "int_ops",
    "trans_flops": "sfu_ops", "hbm_bw": "dram_bw", "vmem_bw": "smem_bw",
    "cmem_bw": "const_bw", "hbm_bytes": "dram_bytes",
    "vmem_bytes": "smem_bytes", "cores": "sms", "ici_bw": "nvlink_bw",
    "ici_links": "nvlink_links", "dcn_bw": "net_bw",
    "launch_latency": "launch_latency",
}
INPUTS = {"2048": "DEFAULT_INPUT", "128": "SQUARE_SMALL",
          "16x4096": "RECT_TALL", "4096x16": "RECT_WIDE"}


def port_spec(j):
    """A JAX ``HardwareSpec`` as a port spec, field by field."""
    return phw.HardwareSpec(**{FIELD_MAP[f.name]: getattr(j, f.name)
                               for f in dataclasses.fields(j)})


def to_tpu(d):
    return {PC.TPU_NAMES[k]: v for k, v in d.items()}


def gemm_inputs(tag):
    return getattr(jspace, INPUTS[tag]), getattr(pspace, INPUTS[tag])


def test_field_map_covers_both_specs():
    assert set(FIELD_MAP) == {f.name for f in dataclasses.fields(jhw.HardwareSpec)}
    port_fields = {f.name for f in dataclasses.fields(phw.HardwareSpec)}
    assert set(FIELD_MAP.values()) | {"l2_bytes", "power_w",
                                      "tf32_flops", "bf16_flops"} \
        == port_fields


def test_counter_map_is_one_to_one_and_in_order():
    from repro.core import counters as jc

    assert [PC.TPU_NAMES[k] for k in PC.PC_OPS] == list(jc.PC_OPS)
    assert [PC.TPU_NAMES[k] for k in PC.PC_STRESS] == list(jc.PC_STRESS)
    assert len(set(PC.TPU_NAMES.values())) == len(PC.TPU_NAMES)
    assert PC.TPU_NAMES[PC.WARP_E_HINT] == "LANE_E_HINT"


@pytest.mark.parametrize("which", ["reduced", "full", *INPUTS])
def test_spaces_are_identical(which):
    if which == "reduced":
        j, p = jspace.make_space(), pspace.make_space()
    elif which == "full":
        j, p = jspace.make_full_space(), pspace.make_full_space()
    else:
        ji, pi = gemm_inputs(which)
        assert dataclasses.astuple(ji) == dataclasses.astuple(pi)
        j, p = jspace.make_space(ji), pspace.make_space(pi)
    assert j.name == p.name
    assert p.configs == j.configs
    assert np.array_equal(p.feature_matrix, j.feature_matrix)
    assert np.array_equal(p.subspace_key_matrix, j.subspace_key_matrix)


def test_space_sizes():
    assert len(pspace.make_space()) == 256
    sizes = sorted(len(pspace.make_space(gemm_inputs(t)[1])) for t in INPUTS)
    assert sizes == [64, 64, 72, 256]


@pytest.mark.parametrize("tag", list(INPUTS) + ["full"])
def test_workload_fn_equals_jax_under_the_name_map(tag):
    if tag == "full":
        space = jspace.make_full_space()
        ji, pi = jspace.DEFAULT_INPUT, pspace.DEFAULT_INPUT
    else:
        ji, pi = gemm_inputs(tag)
        space = jspace.make_space(ji)
    for cfg in space:
        assert to_tpu(pspace.workload_fn(cfg, pi)) == jspace.workload_fn(cfg, ji)


@pytest.mark.parametrize("spec", sorted(jhw.SPECS))
@pytest.mark.parametrize("tag", list(INPUTS))
def test_execute_equals_jax_on_converted_specs(spec, tag):
    jh = jhw.SPECS[spec]
    ph = port_spec(jh)
    ji, pi = gemm_inputs(tag)
    for cfg in jspace.make_space(ji):
        j = jcost.execute(jspace.workload_fn(cfg, ji), jh)
        p = pcost.execute(pspace.workload_fn(cfg, pi), ph)
        np.testing.assert_allclose(p.runtime, j.runtime, rtol=1e-12, atol=0)
        for ours, theirs in ((p.ops, j.ops), (p.stress, j.stress)):
            ours = to_tpu(ours)
            assert set(ours) == set(theirs)
            for k in theirs:
                np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12,
                                           atol=0, err_msg=k)


@pytest.mark.parametrize("hw", [phw.H100_SXM, phw.H100_PCIE,
                                port_spec(jhw.TPU_V5E)],
                         ids=lambda h: h.name)
def test_stress_from_runtime_reproduces_execute(hw):
    for cfg in pspace.make_space():
        ops = pspace.workload_fn(cfg, pspace.DEFAULT_INPUT)
        modelled = pcost.execute(ops, hw)
        derived = pcost.stress_from_runtime(ops, hw, modelled.runtime)
        assert derived.stress == modelled.stress
        assert derived.ops == modelled.ops
        assert derived.runtime == modelled.runtime


def test_stress_from_runtime_scales_with_the_measured_time():
    hw = phw.H100_SXM
    ops = pspace.workload_fn(pspace.make_space()[0], pspace.DEFAULT_INPUT)
    fast = pcost.stress_from_runtime(ops, hw, 1e-3)
    slow = pcost.stress_from_runtime(ops, hw, 2e-3)
    assert slow.stress[PC.DRAM_U] == pytest.approx(fast.stress[PC.DRAM_U] / 2)
    assert slow.stress[PC.SM_E] == fast.stress[PC.SM_E]
    assert slow.ops[PC.LOCAL_B] == fast.ops[PC.LOCAL_B]
