"""tune_s: the window's seconds over the episodes ended in it, the mean
time of a tune to a well-performing configuration."""


def read(ctx):
    n = len(ctx.window.episodes)
    return ctx.window.seconds / n if n else None
