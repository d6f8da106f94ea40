"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

A cell is a configuration (``configs/<name>.json``: a kernel, its input,
the input its model is trained on, the well set and the check's limits)
under a traffic mix (``traffic/<name>.json``: the driver that makes the
window's load, and its parameters).  Each is found by the names in
``BENCHMARK.json``, and so is every file that serves it: the driver
``drivers/<driver>.py``, each metric's reader ``metrics/<name>.py``, each
number of the check ``checks/<name>.py`` (the keys of the configuration's
``check``), the kernel's ``kernels/<kernel>.py`` and its plain
``reference/<kernel>.py``.  So a cell, a mix, a metric or a check is added
by adding files and entries.  ``withheld.json`` holds cells kept out of
``BENCHMARK.json``, in its format, with the reason.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

import devtrace
import yardstick

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
# Top-level module names the benchmark's process may not hold: JAX, and
# the JAX package that the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def load_file(path: Path):
    """The module in ``path``, loaded under a name of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = "onchip_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("")
                                .parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module        # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, whole, is one
    of ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    driver: object          # drivers/<driver>.py
    kernel: object          # kernels/<kernel>.py
    reference: object       # reference/<kernel>.py
    readers: Dict[str, object]
    checks: Dict[str, object]


def with_withheld(benchmark: Dict) -> Dict:
    """``benchmark`` with the entries of ``withheld.json`` added."""
    withheld = load_json(BENCH_DIR / "withheld.json")
    return {k: (v + withheld.get(k, []) if isinstance(v, list) else v)
            for k, v in benchmark.items()}


def resolve(workload: str, benchmark: Optional[Dict] = None,
            withheld: bool = False) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json`` (with
    ``withheld``, also those of ``withheld.json``), with its files."""
    if benchmark is None:
        benchmark = load_json(CHECKOUT / "BENCHMARK.json")
    if withheld:
        benchmark = with_withheld(benchmark)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in benchmark["configs"] if c["name"] == w["config"])
    config = load_json(CHECKOUT / entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")

    def applies(metric: Dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    end_to_end = [m for m in benchmark["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in benchmark["per_layer"]
                 if m["moves"] in reported and applies(m)]
    readers = {m["name"]: load_file(BENCH_DIR / "metrics" / f"{m['name']}.py")
               for m in end_to_end + per_layer}
    checks = {name: load_file(BENCH_DIR / "checks" / f"{name}.py")
              for name in config["check"]}
    return Cell(workload, int(w["chips"]), config, traffic, end_to_end,
                per_layer,
                load_file(BENCH_DIR / "drivers" / f"{traffic['driver']}.py"),
                load_file(BENCH_DIR / "kernels" / f"{config['kernel']}.py"),
                load_file(BENCH_DIR / "reference" / f"{config['kernel']}.py"),
                readers, checks)


class Spans:
    """Host seconds spent in the searcher (``propose``/``observe``) and in
    the evaluator (each test), recorded by the benchmark around its calls
    into those layers, each call also as an interval of the host's clock, so
    that the trace can say what the host did while the card idled."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.seconds = {"searcher": 0.0, "evaluator": 0.0}
        self.intervals: List[tuple] = []      # (start, end, layer)

    def call(self, layer: str, fn, *args):
        t0 = self.clock()
        try:
            return fn(*args)
        finally:
            t1 = self.clock()
            self.seconds[layer] += t1 - t0
            self.intervals.append((t0, t1, layer))

    def wrap_searcher(self, searcher) -> None:
        propose, observe = searcher.propose, searcher.observe
        searcher.propose = lambda k: self.call("searcher", propose, k)
        searcher.observe = lambda obs: self.call("searcher", observe, obs)


@dataclasses.dataclass
class Setup:
    bench: object
    space: object
    args: tuple
    evaluator: object
    session: object
    sweep_ms: np.ndarray
    well: frozenset
    bound: Dict
    timer: Callable = yardstick.time_ms

    def time_ms(self, idx: int) -> float:
        """Configuration ``idx`` timed again now by the yardstick's loop."""
        import torch

        flush = None
        if self.args[0].is_cuda:
            flush = torch.empty(yardstick.FLUSH_BYTES // 4,
                                dtype=torch.float32, device=self.args[0].device)
        return self.timer(lambda: self.bench.run(self.space[idx], *self.args),
                          flush=flush)


def set_up(cell: Cell, seed: int, device, hw=None,
           timer: Callable = yardstick.time_ms) -> Setup:
    """Inputs from ``seed``, the evaluator, the TP→PC model (trained on the
    configuration's training input by the cost model: no card tests, a
    fixed seed), the configuration's well set, and a sweep of the whole
    space (``tuned_ms``, the roofline and the check read it)."""
    import torch

    from repro_torch.core.evaluate import DeviceKernelEvaluator
    from repro_torch.kernels.registry import BENCHMARKS
    from repro_torch.tuning import (TuningSession, model_from_dict,
                                    model_to_dict)

    phases = {}
    t = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        phases[name] = round(now - t, 3)
        t = now

    cfg, k = cell.config, cell.kernel
    bench = BENCHMARKS[k.KERNEL]
    inp = k.make_input(cfg["input"])
    train_inp = k.make_input(cfg["training_input"])
    space = k.make_space(bench, inp)
    train_space = k.make_space(bench, train_inp)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed % 2**64)
    args = k.make_args(inp, generator, device)

    phase("inputs")
    evaluator = DeviceKernelEvaluator(space, bench, inp, hw=hw, device=device)
    evaluator.args = args    # the benchmark's inputs, drawn from --seed
    phase("evaluator")

    m = cfg["model"]
    trainer = TuningSession(train_space,
                            lambda c: bench.workload_fn(c, train_inp),
                            hw=evaluator.hw, seed=int(m["seed"]))
    trainer.train(kind=m["kind"], sample=m["sample"])
    artifact = model_to_dict(trainer.model, train_space)
    session = TuningSession(space, lambda c: bench.workload_fn(c, inp),
                            hw=evaluator.hw,
                            model=model_from_dict(artifact, space=space))
    phase("model")

    flush = None
    if torch.device(device).type == "cuda":
        flush = torch.empty(yardstick.FLUSH_BYTES // 4, dtype=torch.float32,
                            device=device)
        # the card at the clocks of sustained work before the first timing
        yardstick.warm_up(lambda: bench.run(space[0], *args), flush)
    phase("warm_up")
    sweep = np.array([timer(lambda c=c: bench.run(c, *args), flush=flush)
                      for c in space])
    del flush
    phase("sweep")
    well = frozenset(space.index_of(c) for c in cfg["well_set"])
    ratios = sweep / sweep.min()
    inside = sorted(int(i) for i in np.flatnonzero(
        ratios <= cfg["well_factor"]))
    log(f"[setup] {cell.name}: model {m['kind']} trained on "
        f"{train_inp.tag} ({len(train_space)} configurations), digest "
        f"{digest(artifact)}")
    log(f"[setup] {cell.name}: well set {len(well)} {digest(sorted(well))} "
        f"{sorted(well)}; this run's sweep of {len(space)} configurations: "
        f"best {sweep.min():.6f} ms ({space[int(sweep.argmin())]}), worst "
        f"{sweep.max():.6f} ms, within {cfg['well_factor']}x "
        f"{len(inside)} {digest(inside)} {inside}, the well set's ratios "
        f"{[round(float(ratios[i]), 4) for i in sorted(well)]}")
    log(f"[setup] {cell.name}: seconds by phase {phases}")
    return Setup(bench, space, args, evaluator, session, sweep, well,
                 yardstick.bound_ms(k.work(inp)), timer)


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|, in float64."""
    return float((out.double() - ref).abs().max() / ref.abs().max())


def check(cell: Cell, setup: Setup, window) -> Dict[str, Dict]:
    """Each number of the configuration's ``check``, read by
    ``checks/<name>.py`` once the program's state is freed, with its
    limit."""
    import torch

    setup.evaluator = setup.session = None      # the program's state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {name: {"value": float(cell.checks[name].read(cell, setup,
                                                         window)),
                   "limit": limit}
            for name, limit in cell.config["check"].items()}


@dataclasses.dataclass
class RunContext:
    """What the metrics' readers read."""
    kernel: str
    setup_s: float
    window: object          # what the cell's driver returns
    sweep_ms: np.ndarray
    bound: Dict
    spans: Optional[Spans] = None
    trace: Optional[Dict] = None


def read_metrics(entries: List[Dict], readers: Dict, ctx: RunContext
                 ) -> Dict[str, Dict]:
    """Each metric its reader finds something to read for, with its unit."""
    out = {}
    for m in entries:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, hw=None, timer: Callable = yardstick.time_ms,
             clock: Callable[[], float] = time.perf_counter) -> Dict:
    """Set up, warm up, measure, check; returns the result line's object.
    ``t0`` is the clock's reading when the run started."""
    import torch

    setup = set_up(cell, seed, device, hw=hw, timer=timer)
    t = clock()
    cell.driver.warm_up(setup, cell.traffic, clock)
    log(f"[setup] {cell.name}: warm-up {clock() - t:.3f} s")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = clock() - t0

    spans = Spans(clock) if trace else None
    with devtrace.traced(trace, on_card, clock) as tracer:
        window = cell.driver.window(setup, cell.traffic, seconds, seed,
                                    clock, spans)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    for line in window.report():
        log(f"[window] {cell.name}: {line}")

    trace_read = None
    if tracer is not None:
        t = clock()
        trace_read = devtrace.read(tracer, spans.intervals, window.start,
                                   window.start + window.seconds)
        log(f"[trace] {trace_read['events']} operations on the card, read "
            f"in {clock() - t:.3f} s")
    del tracer
    ctx = RunContext(cell.kernel.KERNEL, setup_s, window,
                     setup.sweep_ms, setup.bound, spans, trace_read)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           cell.readers, ctx)
    checks = check(cell, setup, window)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for name, c in checks.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if trace_read is not None:
        device_info["busy_s"] = trace_read["busy_s"]
        device_info["window_s"] = trace_read["window_s"]
        result["breakdown"] = trace_read["breakdown"]
    result["checks"] = checks
    return result
