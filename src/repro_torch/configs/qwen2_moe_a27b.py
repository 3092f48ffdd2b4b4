"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 4 shared + 60 routed top-4
(port of `repro.configs.qwen2_moe_a27b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def qwen2_moe_a27b() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5632,  # shared-expert hidden (4 shared experts of 1408 fused = 5632)
        vocab_size=151936,
        num_experts=60,
        num_experts_per_tok=4,
        num_shared_experts=4,
        moe_d_ff=1408,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        supports_long_context=False,
    )
