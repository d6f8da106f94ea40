"""tests_to_well: the mean count of empirical tests an episode made, over
the episodes ended in the window (the evaluator's account)."""
import numpy as np


def read(ctx):
    eps = ctx.window.episodes
    return float(np.mean([e.tests for e in eps])) if eps else None
