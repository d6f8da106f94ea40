"""On the card only (``python -m pytest -q -m gpu onchip_bench``): the MLA
cell through the benchmark's command for a few seconds, traced, is correct
and reads the (192, 128) instance's roofline share, whose time the trace
gives under the instance's own name."""
import json
import subprocess
import sys

import pytest

import harness

CELL = "mla-deepseek-v2.profile"


@pytest.mark.gpu
def test_a_short_traced_run_of_the_mla_cell(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "onchip_bench/run.py", "--workload", CELL,
         "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["metrics"]["mla_attention_roofline"]["value"] <= 100
    assert "flash_tf32x3_kernel<192, 128," in json.dumps(
        result["breakdown"])
