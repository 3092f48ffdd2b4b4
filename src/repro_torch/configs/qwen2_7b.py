"""Qwen2-7B [arXiv:2407.10671; hf] — dense GQA with QKV bias (port of
`repro.configs.qwen2_7b`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def qwen2_7b() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-7b",
        family="dense",
        source="arXiv:2407.10671; hf",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        supports_long_context=False,
    )
