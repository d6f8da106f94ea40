"""tune_s.p95: the 95th percentile of the seconds of every episode ended in
the window (numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    times = [e.seconds for e in ctx.window.episodes]
    return float(np.percentile(times, 95)) if times else None
