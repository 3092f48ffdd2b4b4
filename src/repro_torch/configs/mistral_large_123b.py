"""Mistral-Large 123B [hf:mistralai/Mistral-Large-Instruct-2407] — dense GQA
(port of `repro.configs.mistral_large_123b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def mistral_large_123b() -> ArchConfig:
    return ArchConfig(
        arch_id="mistral-large-123b",
        family="dense",
        source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        head_dim=128,
        rope_theta=1_000_000.0,
        supports_long_context=False,
    )
