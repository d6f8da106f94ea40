"""Tuning-config dict -> conv2d kernel invocation."""
from repro_torch.kernels.conv2d.kernel import conv2d


def run(cfg, img, flt):
    return conv2d(img, flt, by=cfg["BY"], bx=cfg["BX"],
                  unroll_taps=cfg["UNROLL_TAPS"],
                  filter_smem=cfg["FILTER_SMEM"], dma_depth=cfg["DMA_DEPTH"])
