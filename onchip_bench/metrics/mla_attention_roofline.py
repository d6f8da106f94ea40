"""mla_attention_roofline: the latent-attention prefill's roofline bound
(the frozen yardstick, ``kernels/mla_attention.py``'s work) over the best
time of the set-up sweep, in percent; the MLA cells only."""
import yardstick


def read(ctx):
    return yardstick.roofline_percent("attention", ctx)
