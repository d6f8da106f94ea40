"""xLSTM-125M: alternating sLSTM + mLSTM blocks [arXiv:2405.04517;
unverified]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, xlstm=True, sub_quadratic=True,
)

SMOKE = ARCH.scaled(
    name="xlstm-smoke", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=512, dtype="float32",
)
