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
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

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
                "repro_torch.kernels.registry"} | {
        f"repro_torch.kernels.{k}.{part}"
        for k in ("matmul", "transpose", "conv2d", "coulomb", "nbody",
                  "attention")
        for part in ("kernel", "ops", "ref", "space")}
    assert expected <= set(names)


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
