"""A whole run on the CPU, past the harness's look for a card, at sizes a
test run holds: sound, ``correct`` comes out true; with the timed path
broken underneath (an answer altered where it is produced, half of the
batch left out, the session's answer altered), it comes out false.  The
cells are one of ``BENCHMARK.json`` and one of ``withheld.json``.

Times are made deterministic: the sweep and the evaluator both read the
analytic machine's runtime of each configuration, so that the session's
answers can be held to the sweep exactly as on the card."""
import time

import pytest
import torch

import harness
from repro_torch.core import costmodel, hwspec
from repro_torch.core.evaluate import DeviceKernelEvaluator
from repro_torch.kernels.registry import BENCHMARKS
from repro_torch.tuning import TuningSession

TINY = {"matmul": {"m": 128, "n": 128, "k": 128},
        "attention": {"batch": 2, "heads": 2, "seq": 128, "head_dim": 64,
                      "causal": True}}
CELLS = ["gemm-2048.profile", "attention-qwen1.5-0.5b.random"]


def key(cfg):
    return tuple(sorted(cfg.items()))


@pytest.fixture
def tiny(monkeypatch, request):
    """The cell at a tiny input, with every configuration's time taken from
    the analytic machine, and the well set those times give."""
    cell = harness.resolve(request.param, withheld=True)
    bench = BENCHMARKS[cell.kernel.KERNEL]
    cell.config["input"] = TINY[cell.kernel.KERNEL]
    inp = cell.kernel.make_input(cell.config["input"])
    space = cell.kernel.make_space(bench, inp)
    ms = {key(c): costmodel.execute(bench.workload_fn(c, inp),
                                    hwspec.H100_SXM).runtime * 1e3
          for c in space}
    best = min(ms.values())
    cell.config["well_set"] = [c for c in space if ms[key(c)] <= 1.1 * best]
    last = {}
    run = bench.run

    def recording_run(cfg, *args):
        last["cfg"] = cfg
        return run(cfg, *args)

    def timer(fn, flush=None):
        fn()
        return ms[key(last["cfg"])]

    monkeypatch.setattr(bench, "run", recording_run)
    monkeypatch.setattr(DeviceKernelEvaluator, "_time",
                        lambda self, cfg: ms[key(cfg)] * 1e-3)
    return cell, bench, timer


def run(cell, timer):
    result = harness.run_cell(cell, 2**31 + 11, 1.0, False,
                              torch.device("cpu"), time.perf_counter(),
                              hw=hwspec.H100_SXM, timer=timer)
    assert result["attempted"] > 0
    return result


@pytest.mark.parametrize("tiny", CELLS, indirect=True)
def test_a_sound_run_is_correct(tiny):
    cell, _, timer = tiny
    result = run(cell, timer)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("tiny", CELLS, indirect=True)
@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
def test_a_broken_kernel_is_not_correct(tiny, fault, monkeypatch):
    cell, bench, timer = tiny
    run_ = bench.run

    def broken(cfg, *args):
        out = run_(cfg, *args)
        if fault == "answer_altered":
            out.view(-1)[out.numel() // 3] += 0.5
        else:
            out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(bench, "run", broken)
    result = run(cell, timer)
    assert not result["correct"]
    assert result["checks"]["kernel_rel_err"]["value"] > \
        result["checks"]["kernel_rel_err"]["limit"]


@pytest.mark.parametrize("tiny", CELLS, indirect=True)
@pytest.mark.parametrize("answer", ["slowest_tested", "never_tested"])
def test_an_altered_answer_of_the_session_is_not_correct(tiny, answer,
                                                         monkeypatch, capsys):
    cell, _, timer = tiny
    tune = TuningSession.tune

    def altered(self, *args, evaluator=None, **kw):
        result = tune(self, *args, evaluator=evaluator, **kw)
        tested = {i for i, _ in evaluator.history()}
        if answer == "slowest_tested":
            idx = max(evaluator.history(), key=lambda h: h[1])[0]
        else:
            idx = next(i for i in range(len(self.space)) if i not in tested)
        result.best_config = self.space[idx]
        return result

    monkeypatch.setattr(TuningSession, "tune", altered)
    result = run(cell, timer)
    assert not result["correct"]
    name = "best_outside" if answer == "slowest_tested" else "best_untested"
    assert result["checks"][name]["value"] > result["checks"][name]["limit"]
    if answer == "slowest_tested":
        # each such episode's witness: both configurations, timed again
        witnesses = [line for line in capsys.readouterr().err.splitlines()
                     if line.startswith("[witness]")]
        assert 1 <= len(witnesses) <= 5
        assert all("returned" in w and "again" in w for w in witnesses)
