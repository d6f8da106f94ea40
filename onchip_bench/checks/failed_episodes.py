"""failed_episodes: the window's episodes that raised, or whose search
stopped before it reached the well set.  Exact: its limit is 0."""


def read(cell, setup, window):
    return float(len(window.failures))
