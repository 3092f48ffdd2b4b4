"""ZeRO-1 rules: the AdamW m/v states' sharding over the data-parallel axes
(port of `repro.optim.zero`).

Optimizer states get their own logical->physical rules, in which the
'embed' dim maps to ('pod', 'data'), so each DP rank would own a 1/|DP|
slice of every m/v tensor.  These are rules only, as in the reference:
nothing here shards the optimizer state at run time.
"""

from __future__ import annotations

from typing import Any

from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules

__all__ = ["zero1_rules", "zero1_state_axes"]


def zero1_rules(base: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """Optimizer-state rules: embed dim additionally sharded over DP."""
    return base.replace(embed=("pod", "data"), layers=None)


def zero1_state_axes(param_axes: Any) -> Any:
    """m/v logical axes == param axes (the rules table does the ZeRO remap)."""
    return {"m": param_axes, "v": param_axes, "count": None}
