"""Assigned-architecture configs: one module per arch, plus the catalog.

The JAX package's ``repro.configs``, data only, carried over unchanged;
``repro_torch.models.registry.build_model`` builds every entry.
"""
from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b,
                                 gemma_2b, internvl2_76b, llama4_scout_17b,
                                 qwen1_5_0_5b, qwen2_5_3b,
                                 seamless_m4t_large_v2, xlstm_125m,
                                 zamba2_2_7b)

ARCHS = {
    m.ARCH.name: m.ARCH for m in (
        deepseek_v2_236b, llama4_scout_17b, qwen2_5_3b, command_r_plus_104b,
        qwen1_5_0_5b, gemma_2b, zamba2_2_7b, xlstm_125m, internvl2_76b,
        seamless_m4t_large_v2,
    )
}
SMOKES = {
    m.ARCH.name: m.SMOKE for m in (
        deepseek_v2_236b, llama4_scout_17b, qwen2_5_3b, command_r_plus_104b,
        qwen1_5_0_5b, gemma_2b, zamba2_2_7b, xlstm_125m, internvl2_76b,
        seamless_m4t_large_v2,
    )
}


def get_arch(name: str):
    return ARCHS[name]
