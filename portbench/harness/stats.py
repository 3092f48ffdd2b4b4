"""Order statistics the harness reports."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th quantile by nearest rank: the smallest value with at least
    a q share of the values at or below it."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]
