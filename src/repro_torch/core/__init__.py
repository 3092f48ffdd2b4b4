"""Core: the paper's contribution — mesh array, scrambling transformation, symmetries."""

from repro_torch.core.mesh_array import (
    SimResult,
    mesh_completion_times,
    mesh_matmul_reference,
    mesh_start_times,
    simulate_mesh,
    simulate_standard,
    standard_completion_times,
)
from repro_torch.core.scramble import (
    apply_scramble,
    apply_scramble_power,
    block_scramble_perm,
    cycle_decomposition,
    inverse_perm,
    power_perm,
    scramble_order,
    scramble_perm,
    sigma,
    sigma_table,
    unscramble,
)
from repro_torch.core.symmetries import (
    check_antidiagonal_structure,
    check_mirror_rows,
    check_row1_diagonal,
    paper_symmetric_bound,
    symmetric_readout_schedule,
    symmetric_readout_steps,
)

__all__ = [
    "SimResult",
    "simulate_mesh",
    "simulate_standard",
    "mesh_matmul_reference",
    "mesh_start_times",
    "mesh_completion_times",
    "standard_completion_times",
    "sigma",
    "sigma_table",
    "scramble_perm",
    "inverse_perm",
    "power_perm",
    "block_scramble_perm",
    "apply_scramble",
    "apply_scramble_power",
    "unscramble",
    "cycle_decomposition",
    "scramble_order",
    "check_row1_diagonal",
    "check_mirror_rows",
    "check_antidiagonal_structure",
    "symmetric_readout_schedule",
    "symmetric_readout_steps",
    "paper_symmetric_bound",
]
