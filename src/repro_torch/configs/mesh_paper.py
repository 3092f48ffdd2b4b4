"""The paper's own 'architecture': a dense LM whose every GEMM runs on the
mesh-array kernel (port of `repro.configs.mesh_paper`)."""

from repro_torch.configs.base import ArchConfig, register


@register
def mesh_paper() -> ArchConfig:
    return ArchConfig(
        arch_id="mesh-paper",
        family="dense",
        source="Kak 2010 (this paper)",
        num_layers=4,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=32768,
        use_mesh_kernel=True,
        scramble_privacy=True,
        supports_long_context=False,
    )
