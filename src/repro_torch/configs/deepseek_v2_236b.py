"""DeepSeek-V2 236B: MLA + 2-shared/160-routed top-6 MoE [arXiv:2405.04434]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                 # dense-equivalent hidden (shared path)
    moe_d_ff=1536, n_experts=160, top_k=6, n_shared_experts=2,
    vocab_size=102400, head_dim=128,
    kv_lora_rank=512, qk_rope_dim=64, v_head_dim=128,
)

SMOKE = ARCH.scaled(
    name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, moe_d_ff=32, n_experts=8, top_k=2,
    n_shared_experts=1, vocab_size=512, kv_lora_rank=32, qk_rope_dim=8,
    v_head_dim=16, dtype="float32",
)
