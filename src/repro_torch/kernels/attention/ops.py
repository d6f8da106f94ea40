"""Tuning-config dict -> flash-attention kernel invocation (causal, as the
registry runs it).  Every parameter changes the code path (see
``csrc/attention.cu``)."""
from repro_torch.kernels.attention.kernel import flash_attention


def run(cfg, q, k, v):
    return flash_attention(q, k, v, block_q=cfg["BLOCK_Q"],
                           block_k=cfg["BLOCK_K"], keep_p=cfg["KEEP_P"],
                           q_prefetch=cfg["Q_PREFETCH"])
