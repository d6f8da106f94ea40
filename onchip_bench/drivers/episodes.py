"""The ``episodes`` driver: tuning episodes back to back, closed loop.

One episode is one tune as a kernel author runs it with the port:
``TuningSession.tune`` (the port's ``run_search`` loop) with a new searcher
and a fresh account over the set-up's ``DeviceKernelEvaluator``.  It ends at
its first test of a configuration in the configuration's well set: those
within the well factor of the best time (paper §4.1) by the benchmark's own
sweeps on the card, fixed in the configuration's file so that no run puts a
configuration near the line on the other side of it.  Episodes run back to
back until the window closes.

A traffic file names this driver with ``"driver": "episodes"`` and gives
``searcher`` (a name in the port's ``SEARCHERS``), ``options`` and
``seed_pool``.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# The search loop's budget: an episode ends by the stop rule, and a finite
# space always holds a well-performing configuration.
UNBOUNDED = 10**9


def episode_evaluator(inner, well, deadline: float,
                      clock: Callable[[], float], spans):
    """A fresh account over ``inner`` for one episode.  Its tests go to the
    card through ``inner._evaluate``, as the port's ``VirtualAsyncEvaluator``
    drives an inner evaluator; the search loop finds it exhausted once a
    configuration of ``well`` has been tested or the window has closed."""
    from repro_torch.core.account import Evaluator

    class EpisodeEvaluator(Evaluator):
        reached = False

        def _evaluate(self, idx, profiled):
            if spans is None:
                out = inner._evaluate(idx, profiled)
            else:
                out = spans.call("evaluator", inner._evaluate, idx, profiled)
            self.reached = self.reached or idx in well
            return out

        def exhausted(self) -> bool:
            # an episode begun before the close makes at least one test:
            # the port's tune refuses a search that made none
            return (self.reached or (self.steps > 0 and clock() >= deadline)
                    or super().exhausted())

    return EpisodeEvaluator(inner.space)


@dataclasses.dataclass
class Episode:
    seed: int                    # the searcher's seed
    seconds: float
    best: Optional[int]          # the configuration the tune returned
    history: Tuple[Tuple[int, float], ...]   # (configuration, seconds) a test
    reached: bool                # ended at a well-set configuration

    @property
    def tests(self) -> int:
        return len(self.history)

    @property
    def tested(self) -> frozenset:
        return frozenset(i for i, _ in self.history)


def episode_seeds(pool: int, order_seed: int) -> Iterator[int]:
    """The searcher seeds 0 .. pool - 1, over and over, each pass in an
    order drawn from the run's seed: every run tunes the same episodes."""
    rng = np.random.default_rng(order_seed % 2**64)
    while True:
        yield from (int(s) for s in rng.permutation(pool))


def run_episode(setup, traffic: Dict, seed: int, deadline: float,
                clock: Callable[[], float], spans) -> Episode:
    ev = episode_evaluator(setup.evaluator, setup.well, deadline, clock,
                           spans)
    t0 = clock()
    searcher = setup.session.make_searcher(traffic["searcher"], seed=seed,
                                           **traffic.get("options", {}))
    if spans is not None:
        spans.wrap_searcher(searcher)
    result = setup.session.tune(budget=UNBOUNDED, searcher=searcher,
                                evaluator=ev)
    best = setup.space.index_of(result.best_config)
    return Episode(seed, clock() - t0, best, tuple(ev.history()), ev.reached)


@dataclasses.dataclass
class Window:
    start: float                 # the clock's reading at the window's start
    seconds: float
    episodes: List[Episode]      # ended at a well-set configuration
    failures: List[str]          # raised, or the search stopped first
    tests: int                   # every test the window made

    @property
    def attempted(self) -> int:
        return len(self.episodes) + len(self.failures)

    @property
    def failed(self) -> int:
        return len(self.failures)

    def report(self) -> List[str]:
        """The window's lines for the run's log."""
        return ([f"failed episode:\n{f}" for f in self.failures[:3]]
                + [f"{len(self.episodes)} episodes ended and "
                   f"{len(self.failures)} failed in {self.seconds:.3f} s, "
                   f"{self.tests} tests"])


def warm_up(setup, traffic: Dict, clock: Callable[[], float]) -> None:
    """One episode on a searcher seed outside the window's pool."""
    run_episode(setup, traffic, int(traffic["seed_pool"]), float("inf"),
                clock, None)


def window(setup, traffic: Dict, seconds: float, order_seed: int,
           clock: Callable[[], float] = time.perf_counter,
           spans=None) -> Window:
    """Episodes back to back for ``seconds``; the episode that the close
    cuts counts in the window's time and in no episode."""
    seeds = episode_seeds(int(traffic["seed_pool"]), order_seed)
    episodes: List[Episode] = []
    failures: List[str] = []
    tests = 0
    start = clock()
    deadline = start + seconds
    while clock() < deadline:
        seed = next(seeds)
        try:
            e = run_episode(setup, traffic, seed, deadline, clock, spans)
        except Exception:     # the program failed: count it and go on
            failures.append(traceback.format_exc())
            continue
        tests += e.tests
        if e.reached:
            episodes.append(e)
        elif clock() < deadline:
            failures.append(f"searcher seed {seed}: the search stopped "
                            f"after {e.tests} tests without reaching the "
                            "well set")
    return Window(start, clock() - start, episodes, failures, tests)
