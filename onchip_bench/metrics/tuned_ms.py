"""tuned_ms: the mean over the window's episodes of the kernel time, by the
set-up sweep, at the configuration each returned as its best."""
import numpy as np


def read(ctx):
    eps = ctx.window.episodes
    return float(np.mean([ctx.sweep_ms[e.best] for e in eps])) if eps \
        else None
