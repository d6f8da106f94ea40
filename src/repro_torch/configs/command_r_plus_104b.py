"""Command R+ 104B: dense GQA, no bias [hf:CohereForAI; unverified]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000,
)

SMOKE = ARCH.scaled(
    name="command-r-plus-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=192, vocab_size=512, dtype="float32",
)
