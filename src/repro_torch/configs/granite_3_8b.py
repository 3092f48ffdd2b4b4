"""Granite-3 8B [hf:ibm-granite/granite-3.0 family] — dense GQA with tied
embeddings (port of `repro.configs.granite_3_8b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def granite_3_8b() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-3-8b",
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=10_000.0,
        tie_embeddings=True,
        supports_long_context=False,
    )
