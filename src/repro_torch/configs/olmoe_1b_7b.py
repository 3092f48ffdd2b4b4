"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64-expert top-8 MoE (port of
`repro.configs.olmoe_1b_7b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def olmoe_1b_7b() -> ArchConfig:
    return ArchConfig(
        arch_id="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060; hf",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,  # dense d_ff unused (no shared experts); kept for reference
        vocab_size=50304,
        num_experts=64,
        num_experts_per_tok=8,
        num_shared_experts=0,
        moe_d_ff=1024,
        rope_theta=10_000.0,
        supports_long_context=False,
    )
