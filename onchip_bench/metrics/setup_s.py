"""setup_s: seconds from the run's start to the window's (imports, the
kernels' build where it is not cached, inputs, the model, the sweep and a
warm-up episode)."""


def read(ctx):
    return ctx.setup_s
