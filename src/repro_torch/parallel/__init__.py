"""Distribution layer (port of `repro.parallel`): the paper's array across
devices (`systolic`), the ring collective matmuls (`collectives`), the
logical-axis sharding rules and tree shardings (`sharding`), pipeline
parallelism (`pipeline`) and the int8 error-feedback all-reduce
(`compression`)."""

from repro_torch.parallel.collectives import (
    matmul_ring_reducescatter,
    psum_if_multi,
    ring_allgather_matmul,
    ring_pipeline_matmul,
)
from repro_torch.parallel.compression import (
    compressed_pmean_tree,
    compressed_psum_mean,
    init_error_state,
)
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply, pipeline_ticks
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    PARAM_RULES,
    SP_DECODE_RULES,
    TRAIN_RULES,
    NamedSharding,
    ShardingRules,
    constrain,
    gather_global,
    logical_to_physical,
    named_sharding,
    shard_of,
    tree_shardings,
)
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
    "pipeline_apply",
    "pipeline_ticks",
    "bubble_fraction",
    "ring_allgather_matmul",
    "matmul_ring_reducescatter",
    "ring_pipeline_matmul",
    "psum_if_multi",
    "compressed_psum_mean",
    "compressed_pmean_tree",
    "init_error_state",
    "ShardingRules",
    "DEFAULT_RULES",
    "PARAM_RULES",
    "TRAIN_RULES",
    "SP_DECODE_RULES",
    "NamedSharding",
    "constrain",
    "logical_to_physical",
    "named_sharding",
    "tree_shardings",
    "shard_of",
    "gather_global",
]
