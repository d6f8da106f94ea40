"""Tuning-config dict -> conv2d kernel invocation.  DMA_DEPTH is priced by
the workload model only (see ``csrc/conv2d.cu``)."""
from repro_torch.kernels.conv2d.kernel import conv2d


def run(cfg, img, flt):
    return conv2d(img, flt, by=cfg["BY"], bx=cfg["BX"],
                  unroll_taps=cfg["UNROLL_TAPS"],
                  filter_smem=cfg["FILTER_SMEM"])
