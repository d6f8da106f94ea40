"""The window's arithmetic on an evaluator of known times: an episode ends
at its first test of a well-set configuration, ``tune_s`` is the window's
seconds over every episode ended in it, ``tune_s.p95`` the percentile of
all of those episodes, and the episode the close cuts counts in no
episode."""
import numpy as np
import pytest

import harness
from repro_torch.core import hwspec
from repro_torch.core.evaluate import TEST_OVERHEAD, CostModelEvaluator
from repro_torch.kernels.matmul.space import GemmInput, make_space, workload_fn
from repro_torch.tuning import TuningSession

INP = GemmInput(2048, 2048, 2048)
EPISODES = harness.load_file(harness.BENCH_DIR / "drivers" / "episodes.py")
TRAFFIC = {"random": {"searcher": "random", "options": {}, "seed_pool": 16},
           "profile": {"searcher": "profile", "options": {"n": 5},
                       "seed_pool": 16}}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class KnownTimes(CostModelEvaluator):
    """The analytic machine's runtimes; each test moves the clock on by its
    cost (the runtime and a fixed overhead), and by nothing else."""

    def __init__(self, space, clock):
        super().__init__(space, lambda c: workload_fn(c, INP),
                         hwspec.H100_SXM)
        self.clock = clock

    def _evaluate(self, idx, profiled):
        rt, cs, cost = super()._evaluate(idx, profiled)
        self.clock.t += cost
        return rt, cs, cost


@pytest.fixture
def setup():
    space = make_space(INP)
    clock = Clock()
    ev = KnownTimes(space, clock)
    runtimes = np.array([ev._counters_for(i).runtime
                         for i in range(len(space))])
    well = frozenset(int(i) for i in
                     np.flatnonzero(runtimes <= 1.1 * runtimes.min()))
    session = TuningSession(space, lambda c: workload_fn(c, INP),
                            hw=hwspec.H100_SXM)
    session.train(sample="deliberate", seed=0)
    s = harness.Setup(None, space, (), ev, session, runtimes * 1e3, well, {})
    return s, clock, runtimes


def random_path(space_size, seed, well):
    order = [int(i) for i in
             np.random.default_rng(seed).permutation(space_size)]
    n = next(k for k, i in enumerate(order, 1) if i in well)
    return order[:n]


@pytest.mark.parametrize("traffic", ["random", "profile"])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_an_episode_ends_at_its_first_well_test(setup, traffic, seed):
    s, clock, runtimes = setup
    e = EPISODES.run_episode(s, TRAFFIC[traffic], seed, float("inf"), clock,
                             None)
    assert e.reached and len(e.tested & s.well) == 1
    assert e.best in e.tested
    if traffic == "random":
        path = random_path(len(s.space), seed, s.well)
        assert e.tests == len(path) and e.tested == frozenset(path)
        assert e.seconds == pytest.approx(
            sum(runtimes[i] + TEST_OVERHEAD for i in path))


@pytest.mark.parametrize("seconds", [2.0, 12.5])
def test_tune_s_is_the_window_over_every_episode(setup, seconds):
    s, clock, runtimes = setup
    traffic = TRAFFIC["random"]
    w = EPISODES.window(s, traffic, seconds, 11, clock=clock)
    # the same window worked out from the searcher's own orders
    seeds = EPISODES.episode_seeds(traffic["seed_pool"], 11)
    t, ended = 0.0, []
    while t < seconds:
        start = t
        for i in random_path(len(s.space), next(seeds), s.well):
            t += runtimes[i] + TEST_OVERHEAD
            if t >= seconds:
                break
        else:
            ended.append(t - start)
            continue
        if i in s.well:
            ended.append(t - start)
    assert w.seconds == pytest.approx(t)
    assert [e.seconds for e in w.episodes] == pytest.approx(ended)
    assert not w.failures and w.attempted == len(ended) and not w.failed
    ctx = harness.RunContext("matmul", 1.0, w, s.sweep_ms, {})
    tune_s = harness.load_file(harness.BENCH_DIR / "metrics" / "tune_s.py")
    p95 = harness.load_file(harness.BENCH_DIR / "metrics" / "tune_s.p95.py")
    tuned = harness.load_file(harness.BENCH_DIR / "metrics" / "tuned_ms.py")
    assert tune_s.read(ctx) == pytest.approx(t / len(ended))
    assert p95.read(ctx) == pytest.approx(np.percentile(ended, 95))
    assert tuned.read(ctx) == pytest.approx(
        np.mean([s.sweep_ms[e.best] for e in w.episodes]))
    assert len(ended) >= 5


def test_every_run_tunes_the_same_pool_in_its_own_order():
    a = EPISODES.episode_seeds(8, 1)
    b = EPISODES.episode_seeds(8, 2**31 + 7)
    first_a = [next(a) for _ in range(16)]
    first_b = [next(b) for _ in range(16)]
    assert sorted(first_a[:8]) == sorted(first_b[:8]) == list(range(8))
    assert sorted(first_a[8:]) == list(range(8))
    assert first_a != first_b
