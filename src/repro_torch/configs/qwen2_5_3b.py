"""Qwen2.5-3B: dense GQA with QKV bias [hf:Qwen/Qwen2.5-3B]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1000000.0,
)

SMOKE = ARCH.scaled(
    name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, dtype="float32",
)
