"""SeamlessM4T-large-v2 backbone: 24+24 enc-dec transformer; speech frontend
STUBBED to precomputed frame embeddings per the assignment
[arXiv:2308.11596]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    enc_layers=24, dec_layers=24,
    frontend="audio", frontend_dim=1024, frontend_len=4096,
)

SMOKE = ARCH.scaled(
    name="seamless-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, enc_layers=2, dec_layers=2,
    frontend_dim=48, frontend_len=8, dtype="float32",
)
