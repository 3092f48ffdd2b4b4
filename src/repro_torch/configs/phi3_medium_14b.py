"""Phi-3-medium 14B [arXiv:2404.14219] — dense, RoPE SwiGLU GQA (port of
`repro.configs.phi3_medium_14b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def phi3_medium_14b() -> ArchConfig:
    return ArchConfig(
        arch_id="phi3-medium-14b",
        family="dense",
        source="arXiv:2404.14219; unverified",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
        supports_long_context=False,
    )
