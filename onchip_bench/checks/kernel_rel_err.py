"""kernel_rel_err: the kernel's output at every distinct configuration the
window's episodes returned, on the run's inputs, against the plain
reference in float64: the largest max |out - ref| / max |ref|."""


def read(cell, setup, window):
    import harness

    returned = sorted({e.best for e in window.episodes})
    ref = cell.reference.reference(*setup.args)
    return max((harness.rel_err(setup.bench.run(setup.space[i], *setup.args),
                                ref) for i in returned),
               default=float("inf"))
