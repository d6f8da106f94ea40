"""The port stands alone: no JAX and no module of the JAX package, and no
quiet fallback from the card to the CPU."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import pytest
import torch

from repro_torch.core import hwspec
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + EXAMPLES

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, json, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(json.dumps(sorted(names)))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"repro_torch.core.searcher", "repro_torch.core.evaluate",
                "repro_torch.tuning.session", "repro_torch.tuning.serialize",
                "repro_torch.tuning.signature", "repro_torch.tuning.store",
                "repro_torch.tuning.problem",
                "repro_torch.kernels.registry",
                "repro_torch.fleet", "repro_torch.fleet.job",
                "repro_torch.fleet.pool", "repro_torch.fleet.tuner",
                "repro_torch.fleet.worker_main",
                "repro_torch.launch.fleet", "repro_torch.launch.signals",
                "repro_torch.launch.daemon", "repro_torch.launch.serve",
                "repro_torch.launch.train", "repro_torch.launch.supervisor",
                "repro_torch.optim.adamw", "repro_torch.train.train_step",
                "repro_torch.data.pipeline",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.distributed.compression",
                "repro_torch.configs", "repro_torch.configs.qwen2_5_3b",
                "repro_torch.distributed.tuning",
                "repro_torch.distributed.api",
                "repro_torch.distributed.sharding",
                "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.launch.tune",
                "repro_torch.roofline.op_count",
                "repro_torch.roofline.analysis",
                "repro_torch.core.step_tuner",
                "repro_torch.serve.engine", "repro_torch.serve.autotune"} | {
        f"repro_torch.models.{m}"
        for m in ("attention", "common", "config", "convert", "encdec",
                  "hybrid", "moe", "registry", "ssm", "transformer",
                  "xlstm")} | {
        f"repro_torch.service.{m}"
        for m in ("client", "daemon", "health", "journal", "protocol",
                  "shards", "tenants")} | {"repro_torch.service"} | {
        f"repro_torch.kernels.{k}.{part}"
        for k in ("matmul", "transpose", "conv2d", "coulomb", "nbody",
                  "attention")
        for part in ("kernel", "ops", "ref", "space")}
    assert expected <= set(names)


_BLOCKED_EXAMPLES = r"""
import importlib.abc, importlib.util, pathlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
for path in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem,
                                                  path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    print(pathlib.Path(path).name)
"""


def test_the_examples_import_with_jax_and_repro_blocked():
    """The port's five examples import (and define ``run`` and ``main``)
    with jax and the JAX package blocked."""
    assert [p.name for p in EXAMPLES] == [
        "torch_autotune_train_step.py", "torch_quickstart.py",
        "torch_serve_autotune.py", "torch_serve_batch.py",
        "torch_train_lm.py"]
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_EXAMPLES, str(ROOT / "src"),
         *map(str, EXAMPLES)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [p.name for p in EXAMPLES]
    for path in EXAMPLES:
        names = {n.name for n in ast.parse(path.read_text()).body
                 if isinstance(n, ast.FunctionDef)}
        assert {"run", "main"} <= names, path


# a fleet worker (priced) and the fleet CLI (virtual backend), each run with
# jax and the JAX package blocked
_BLOCKED_RUN = r"""
import importlib, importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
module = sys.argv[2]
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__")
"""


def test_the_fleet_worker_and_cli_run_with_jax_and_repro_blocked(tmp_path):
    req = json.dumps({"uid": 3, "kernel": "conv2d", "input": "4096",
                      "hw": "h100_sxm", "index": 5, "profile": True})
    worker = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.fleet.worker_main"],
        input=json.dumps({"op": "ping"}) + "\n" + req + "\n",
        capture_output=True, text=True, timeout=300)
    assert worker.returncode == 0, worker.stderr
    pong, reply = (json.loads(x) for x in worker.stdout.splitlines())
    assert pong["op"] == "pong"
    assert reply["uid"] == 3 and reply["runtime"] > 0 and "ops" in reply
    out = tmp_path / "fleet.json"
    cli = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.fleet", "--backend", "virtual", "--kernels",
         "nbody", "--inputs", "16k", "--budget", "3", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert cli.returncode == 0, cli.stderr
    assert json.loads(out.read_text())["jobs"][0]["trials"] == 3


def test_the_dryrun_and_tune_clis_run_with_jax_and_repro_blocked(tmp_path):
    """The dry run counts a production cell (qwen1.5-0.5b's decode on the
    16x16 fake mesh) and the tune CLI prices a sharding problem, with jax
    and the JAX package blocked."""
    out = tmp_path / "cells.jsonl"
    dry = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape",
         "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert dry.returncode == 0, dry.stderr[-3000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    tuned = tmp_path / "tune.json"
    tune = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.tune", "--problem",
         "sharding:qwen2.5-3b/train_4k", "--budget", "3", "--out",
         str(tuned)],
        capture_output=True, text=True, timeout=300)
    assert tune.returncode == 0, tune.stderr[-3000:]
    assert json.loads(tuned.read_text())["trials"] == 3
    assert "blocked import" not in dry.stderr + tune.stderr


def test_the_daemon_cli_runs_with_jax_and_repro_blocked(tmp_path):
    """The daemon CLI (virtual backend) under the import block: it comes
    up, answers a kernel submit and drains on a shutdown request."""
    import threading

    from repro_torch.service import ServiceClient

    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.daemon", "--backend", "virtual", "--port", "0",
         "--store-dir", str(tmp_path / "corpus"), "--budget", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, up = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "tuning service on" in line:
                up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert up.wait(timeout=120), "".join(lines)
        addr = next(x for x in lines if "tuning service on" in x)
        addr = addr.split("tuning service on ")[1].split()[0]
        with ServiceClient(addr, timeout=30) as c:
            r = c.submit_kernel("t", "nbody", "h100_sxm", input="16k")
            assert c.result(r["request_id"], timeout=120)["trials"] == 3
            c.shutdown(drain=True)
        assert proc.wait(timeout=120) == 0, "".join(lines)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert "blocked import" not in "".join(lines)


def test_the_serve_cli_runs_with_jax_and_repro_blocked():
    """``--help``, then a SMOKE model served on the CPU through the online
    autotuner, with jax and the JAX package blocked."""
    def run(*args):
        return subprocess.run(
            [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
             "repro_torch.launch.serve", *args],
            capture_output=True, text=True, timeout=300)

    helped = run("--help")
    assert helped.returncode == 0, helped.stderr
    assert "--device" in helped.stdout and "--autotune" in helped.stdout
    served = run("--smoke", "--device", "cpu", "--requests", "3",
                 "--autotune", "--live-trials", "2")
    assert served.returncode == 0, served.stderr
    assert "qwen2.5-smoke on cpu: 3 requests" in served.stdout
    assert "blocked import" not in served.stderr


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_the_serve_cli_serves_the_recurrent_archs_with_jax_blocked(arch):
    """A SMOKE Zamba2 and xLSTM served on the CPU by the CLI, with jax
    and the JAX package blocked."""
    served = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device",
         "cpu", "--requests", "3"],
        capture_output=True, text=True, timeout=300)
    assert served.returncode == 0, served.stderr
    name = arch.split("-")[0]
    assert f"{name}-smoke on cpu: 3 requests" in served.stdout
    assert "blocked import" not in served.stderr


def test_the_serve_cli_refuses_the_encoder_decoder_with_a_message():
    """The engine feeds tokens only: seamless-m4t-large-v2, whose encoder
    needs frames, is refused before any weight is drawn, not in a
    KeyError."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.serve", "--arch", "seamless-m4t-large-v2"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "the engine serves token-only models" in out.stderr
    assert "Traceback" not in out.stderr and "KeyError" not in out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {mod}"


def test_resolve_device_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("name,spec", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"),
    ("NVIDIA H100 PCIe", "h100_pcie"),
])
def test_detect_picks_the_spec_by_card_name(name, spec):
    assert hwspec.spec_for_device_name(name).name == spec


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL",
                                  "NVIDIA GeForce RTX 4090", "cpu"])
def test_detect_raises_for_an_unknown_card(name):
    with pytest.raises(RuntimeError, match="no hardware spec"):
        hwspec.spec_for_device_name(name)


def test_detect_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        hwspec.detect()


def test_h100_sxm_spec_matches_the_data_sheet():
    hw = hwspec.H100_SXM
    assert (hw.sms, hw.fp32_flops, hw.dram_bw, hw.dram_bytes) == \
        (132, 67e12, 3.35e12, 80e9)
    assert (hw.smem_bytes, hw.l2_bytes, hw.power_w) == (232_448, 50e6, 700.0)
    # the fp32 rate derived per clock agrees with the data sheet's
    assert abs(128 * 2 * hw.sms * 1.98e9 / hw.fp32_flops - 1) < 0.01


def test_tf32_tensor_core_rates_are_the_data_sheets():
    """Dense TF32: the data sheet's rates with sparsity (989 and 756
    TFLOP/s), halved."""
    assert hwspec.H100_SXM.tf32_flops == 495e12
    assert hwspec.H100_PCIE.tf32_flops == 378e12
    assert abs(2 * hwspec.H100_SXM.tf32_flops / 989e12 - 1) < 0.01
    assert abs(2 * hwspec.H100_PCIE.tf32_flops / 756e12 - 1) < 0.01


def test_the_supervisor_and_train_cli_run_with_jax_and_repro_blocked(
        tmp_path):
    """The supervisor re-executes the trainer with the import block in
    neither (a fresh interpreter), so the block is put into the trainer
    directly: a SMOKE model trained on the CPU with checkpoints, then
    resumed by the supervisor from the last one."""
    import os

    ckpt = str(tmp_path / "ck")
    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2", "--ckpt-dir", ckpt]
    trained = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300)
    assert trained.returncode == 0, trained.stderr
    assert "[train] done: final loss" in trained.stdout
    resumed = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src"),
         "repro_torch.launch.supervisor", "--backoff", "0", "--", *args],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert resumed.returncode == 0, resumed.stderr
    assert "[train] restored checkpoint at step 4" in resumed.stdout
    assert "blocked import" not in trained.stderr + resumed.stderr
