"""Gemma 2B: GeGLU, head_dim=256, MQA [arXiv:2403.08295]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256, activation="gelu",
    tie_embeddings=True,
)

SMOKE = ARCH.scaled(
    name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=32, d_ff=128, vocab_size=512, dtype="float32",
)
