"""attention_roofline: causal attention's roofline bound (the frozen
yardstick) over the best time of the set-up sweep, in percent; attention
cells only."""
import yardstick


def read(ctx):
    return yardstick.roofline_percent("attention", ctx)
