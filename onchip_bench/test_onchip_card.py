"""On the card only (``python -m pytest -q -m gpu onchip_bench``): every cell
runs through the benchmark's command, briefly, and is correct; the control
fails each configuration's limit at the configuration's own size."""
import json
import subprocess
import sys

import pytest

import harness

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, "onchip_bench/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {
        m["name"] for m in BENCH["end_to_end"]
        if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.gpu
@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_the_control_fails_at_the_configurations_size(card, config):
    import control

    cell = harness.resolve(next(w["name"] for w in BENCH["workloads"]
                                if w["config"] == config))
    r = control.kernel_readings(cell, (2**31 + 5,), card)
    assert r["lower"] < cell.config["check"]["kernel_rel_err"] < r["upper"]
