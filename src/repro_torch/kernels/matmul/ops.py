"""Tuning-config dict -> GEMM kernel invocation."""
from repro_torch.kernels.matmul.kernel import matmul


def run(cfg, a, b):
    return matmul(a, b, block_m=cfg["BLOCK_M"], block_n=cfg["BLOCK_N"],
                  block_k=cfg["BLOCK_K"], loop_order=cfg["LOOP_ORDER"])
