"""Tuning-config dict -> transpose kernel invocation."""
from repro_torch.kernels.transpose.kernel import transpose


def run(cfg, x):
    return transpose(x, block_m=cfg["BLOCK_M"], block_n=cfg["BLOCK_N"],
                     stage_out=cfg["STAGE_OUT"])
