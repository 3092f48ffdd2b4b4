"""Distribution layer (port of `repro.parallel`): the paper's array across
devices (`systolic`), the ring collective matmuls (`collectives`) and the
logical-axis sharding rules the planner reads (`sharding`)."""

from repro_torch.parallel.collectives import (
    matmul_ring_reducescatter,
    psum_if_multi,
    ring_allgather_matmul,
    ring_pipeline_matmul,
)
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, logical_to_physical
from repro_torch.parallel.systolic import (
    phase_counts,
    ring_systolic_kpass,
    systolic_matmul,
    systolic_matmul_shardmap,
)

__all__ = [
    "systolic_matmul",
    "systolic_matmul_shardmap",
    "ring_systolic_kpass",
    "phase_counts",
    "ring_allgather_matmul",
    "matmul_ring_reducescatter",
    "ring_pipeline_matmul",
    "psum_if_multi",
    "ShardingRules",
    "DEFAULT_RULES",
    "logical_to_physical",
]
