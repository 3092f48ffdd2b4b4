"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay, O(1)-state decode (port of `repro.configs.rwkv6_1b6`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def rwkv6_1b6() -> ArchConfig:
    return ArchConfig(
        arch_id="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892; unverified",
        num_layers=24,
        d_model=2048,
        num_heads=32,  # wkv heads = d_model / head_dim(64)
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        ssm_state_size=64,  # per-head KxV state (head_dim x head_dim)
        supports_long_context=True,
    )
