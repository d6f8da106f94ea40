"""Llama-4-Scout 17B-A 16E: top-1 MoE + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, moe_d_ff=8192, n_experts=16, top_k=1, n_shared_experts=1,
    vocab_size=202048, rope_theta=500000.0,
)

SMOKE = ARCH.scaled(
    name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, moe_d_ff=128, n_experts=4, top_k=1,
    n_shared_experts=1, vocab_size=512, dtype="float32",
)
