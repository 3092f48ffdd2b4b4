"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone with one shared
attention block applied periodically, each application with its own KV cache
(port of `repro.configs.zamba2_1b2`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def zamba2_1b2() -> ArchConfig:
    return ArchConfig(
        arch_id="zamba2-1.2b",
        family="hybrid",
        source="arXiv:2411.15242; hf",
        num_layers=38,  # mamba2 blocks
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,  # shared block MLP hidden
        vocab_size=32000,
        ssm_state_size=64,
        ssm_num_heads=64,  # d_inner(4096) / head_p(64)
        ssm_expand=2,
        shared_attn_period=6,  # shared attn block after every 6 mamba layers
        supports_long_context=True,
    )
