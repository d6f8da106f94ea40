"""best_outside: the window's episodes whose returned best lies outside the
configuration's well set.  Each episode ends at its first test of a
well-set configuration, so such an episode measured another configuration
faster than that one.  Exact: its limit is 0.

For each such episode (the first ``WITNESSES``) it logs the witness: the
searcher's seed, the returned configuration and the well-set one with the
evaluator's readings of each in the episode, the set-up sweep's, and each
timed again now by the yardstick's loop."""
import harness

WITNESSES = 5


def read(cell, setup, window):
    outside = [e for e in window.episodes if e.best not in setup.well]
    for e in outside[:WITNESSES]:
        seen = dict(e.history)
        well = next(i for i, _ in reversed(e.history) if i in setup.well)
        rows = []
        for role, i in (("returned", e.best), ("well", well)):
            rows.append(f"{role} {i} {setup.space[i]}: evaluator "
                        f"{1e3 * seen.get(i, float('nan')):.6f} ms, sweep "
                        f"{setup.sweep_ms[i]:.6f} ms, again "
                        f"{setup.time_ms(i):.6f} ms")
        harness.log(f"[witness] searcher seed {e.seed}, {e.tests} tests: "
                    + "; ".join(rows))
    return float(len(outside))
