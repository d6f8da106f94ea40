"""eval_ms_per_test: host milliseconds around each of the evaluator's
tests (launches, timing, counters) over every test of the window."""


def read(ctx):
    if ctx.spans is None or not ctx.window.tests:
        return None
    return 1e3 * ctx.spans.seconds["evaluator"] / ctx.window.tests
