"""search_ms_per_test: host milliseconds in the searcher's propose and
observe over every test of the window."""


def read(ctx):
    if ctx.spans is None or not ctx.window.tests:
        return None
    return 1e3 * ctx.spans.seconds["searcher"] / ctx.window.tests
