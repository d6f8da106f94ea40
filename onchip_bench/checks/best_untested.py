"""best_untested: the window's episodes whose returned best is a
configuration that the episode did not measure.  Exact: its limit is 0."""


def read(cell, setup, window):
    return float(sum(e.best not in e.tested for e in window.episodes))
