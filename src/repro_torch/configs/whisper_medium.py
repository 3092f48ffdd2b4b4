"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; the conv frontend is a
stub (precomputed frame embeddings) (port of `repro.configs.whisper_medium`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        arch_id="whisper-medium",
        family="audio",
        source="arXiv:2212.04356; unverified",
        num_layers=24,  # total transformer blocks (12 enc + 12 dec at 'medium' scale x2)
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        enc_layers=24,
        dec_layers=24,
        dec_ratio=8,  # assigned shapes: dec_len = seq_len // 8 (enc frames = seq_len)
        rope_theta=10_000.0,  # backbone uses RoPE in this framework (adaptation note)
        supports_long_context=False,
    )
