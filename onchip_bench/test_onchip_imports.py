"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the port.  Each check runs in a fresh
interpreter under a ``sys.meta_path`` hook that records, and refuses, any
import whose top-level name (the part before the first dot), compared
whole, is blocked: ``repro_torch`` begins with ``repro`` and is not the
JAX package."""
import json
import os
import subprocess
import sys

import harness

HOOK = """
import importlib.abc, sys
BLOCKED = set({blocked!r})
attempts = []

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            attempts.append(name)
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [{bench!r}, {src!r}]
"""

RUN_EVERY_CELL = """
import json, time
import torch
import harness, devtrace, yardstick, tf32
import run
from repro_torch.core import hwspec

bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
tiny = {"matmul": {"m": 128, "n": 128, "k": 128},
        "attention": {"batch": 1, "heads": 2, "seq": 128, "head_dim": 64,
                      "causal": True}}
for w in bench["workloads"]:
    cell = harness.resolve(w["name"])
    cell.config["input"] = tiny[cell.kernel.KERNEL]
    inp = cell.kernel.make_input(cell.config["input"])
    from repro_torch.kernels.registry import BENCHMARKS
    space = cell.kernel.make_space(BENCHMARKS[cell.kernel.KERNEL], inp)
    cell.config["well_set"] = [space[0]]
    harness.run_cell(cell, 5, 0.3, True, torch.device("cpu"),
                     time.perf_counter(), hw=hwspec.H100_SXM,
                     timer=lambda fn, flush=None: (fn(), 1.0)[1])
print(json.dumps({"attempts": attempts,
                  "loaded": harness.forbidden_modules()}))
"""

LOAD_REFERENCES = """
import json
import importlib.util, pathlib
for path in sorted(pathlib.Path({bench!r}, "reference").glob("*.py")):
    spec = importlib.util.spec_from_file_location("ref_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({{"attempts": attempts,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in BLOCKED)}}))
"""


def run_blocked(blocked, body):
    code = HOOK.format(blocked=sorted(blocked), bench=str(harness.BENCH_DIR),
                       src=str(harness.CHECKOUT / "src")) + body
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=harness.CHECKOUT, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_of_every_cell_imports_no_jax_and_no_jax_package():
    out = run_blocked({"jax", "jaxlib", "flax", "repro"}, RUN_EVERY_CELL)
    assert out == {"attempts": [], "loaded": []}


def test_the_references_import_nothing_of_the_port():
    out = run_blocked({"jax", "jaxlib", "flax", "repro", "repro_torch"},
                      LOAD_REFERENCES.format(bench=str(harness.BENCH_DIR)))
    assert out == {"attempts": [], "loaded": []}
