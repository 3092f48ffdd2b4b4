"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — mistral-nemo backbone; the
ViT frontend is a stub (precomputed patch embeddings) (port of
`repro.configs.pixtral_12b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        arch_id="pixtral-12b",
        family="vlm",
        source="hf:mistralai/Pixtral-12B-2409; unverified",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        num_stub_patches=256,  # stub ViT: 256 patch embeddings prepended
        rope_theta=1_000_000.0,
        supports_long_context=False,
    )
