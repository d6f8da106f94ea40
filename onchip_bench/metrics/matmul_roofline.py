"""matmul_roofline: the GEMM's roofline bound (the frozen yardstick) over
the best time of the set-up sweep, in percent; GEMM cells only."""
import yardstick


def read(ctx):
    return yardstick.roofline_percent("matmul", ctx)
