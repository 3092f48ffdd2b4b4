"""Core: the paper's scrambling transformation (numpy tables)."""

from repro_torch.core.scramble import (
    cycle_decomposition,
    inverse_perm,
    power_perm,
    scramble_order,
    scramble_perm,
    sigma,
    sigma_table,
)

__all__ = [
    "cycle_decomposition",
    "inverse_perm",
    "power_perm",
    "scramble_order",
    "scramble_perm",
    "sigma",
    "sigma_table",
]
