"""Zamba2-2.7B: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, ssm_state=64, mamba_per_attn=6,
    sub_quadratic=True,
)

SMOKE = ARCH.scaled(
    name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, ssm_state=16, mamba_per_attn=2,
    dtype="float32",
)
