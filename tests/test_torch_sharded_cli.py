"""The train CLI's ``--data-model`` (``repro_torch.launch.train``) on
meshes of CPU ranks: one command trains the sharded step, with the losses
of one device; under the supervisor, a rank that is SIGKILLed brings its
group down and the run resumes from the last checkpoint to the losses of a
run that was not interrupted."""
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    return env


STEP_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) gnorm (\S+)")


def _losses(text):
    return {int(m.group(1)): (m.group(2), m.group(3))
            for m in STEP_LINE.finditer(text)}


def test_the_cli_trains_on_a_2x2_mesh_as_on_one_device(tmp_path):
    args = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--steps", "4", "--batch", "4", "--seq",
            "16"]
    one = subprocess.run(args, capture_output=True, text=True, timeout=240,
                         env=_env(), cwd=tmp_path)
    mesh = subprocess.run(args + ["--data-model", "2", "2"],
                          capture_output=True, text=True, timeout=240,
                          env=_env(), cwd=tmp_path)
    assert one.returncode == 0, one.stderr[-2000:]
    assert mesh.returncode == 0, mesh.stderr[-2000:]
    assert "2x2 (data, model) mesh over gloo" in mesh.stdout
    a, b = _losses(one.stdout), _losses(mesh.stdout)
    assert sorted(a) == sorted(b) == [0, 3]
    for step in a:
        assert abs(float(a[step][0]) - float(b[step][0])) <= 1e-3


def test_a_killed_rank_brings_the_group_down_and_the_run_resumes(tmp_path):
    """``--data-model 2 1`` under the supervisor: rank 1 SIGKILLed once
    step 5 is printed (its checkpoint published); rank 0 is stopped at
    once, the supervisor restarts the run, and it resumes from the last
    checkpoint to the losses of a run that was not interrupted."""
    def cmd(ckpt):
        return [sys.executable, "-m", "repro_torch.launch.supervisor",
                "--backoff", "0.2", "--", "--smoke", "--device", "cpu",
                "--data-model", "2", "1", "--steps", "40", "--batch", "4",
                "--seq", "16", "--ckpt-every", "5", "--ckpt-dir", str(ckpt),
                "--step-timeout", "60"]

    whole = subprocess.run(cmd(tmp_path / "whole"), capture_output=True,
                           text=True, timeout=240, env=_env())
    assert whole.returncode == 0, whole.stderr[-2000:]
    proc = subprocess.Popen(cmd(tmp_path / "killed"), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
    lines, pids, killed_at = [], None, None
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"\[train\] 2 ranks: pids (\d+) (\d+)", line)
            if m and pids is None:
                pids = (int(m.group(1)), int(m.group(2)))
            m = STEP_LINE.search(line)
            if m and killed_at is None and int(m.group(1)) >= 5:
                killed_at = time.perf_counter()
                os.kill(pids[1], signal.SIGKILL)
        rc = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert rc == 0, out[-3000:] + proc.stderr.read()[-2000:]
    assert "rank 1 exited rc=-9: stopping the others" in out
    assert out.count("[supervisor] attempt") == 2
    assert "[train] restored checkpoint at step" in out
    resumed = out[out.index("[train] restored checkpoint"):]
    got, want = _losses(resumed), _losses(whole.stdout)
    assert got and max(got) == 39
    for step, vals in got.items():
        assert vals == want[step], step
