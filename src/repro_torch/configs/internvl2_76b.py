"""InternVL2-76B backbone (InternLM2-like LLM; InternViT frontend STUBBED to
precomputed patch embeddings per the assignment) [arXiv:2404.16821;
unverified]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    frontend="vision", frontend_dim=3200, frontend_len=256,
)

SMOKE = ARCH.scaled(
    name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, frontend_dim=48, frontend_len=4,
    dtype="float32",
)
