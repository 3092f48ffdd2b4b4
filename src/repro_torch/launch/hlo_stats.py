"""Collective traffic of one rank's step (port of `repro.launch.hlo_stats`).

The reference scans the compiled per-device HLO text for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute ops.  An
eager torch step has no HLO: its collectives are the ones this process
issues, which `parallel.collectives.record_collectives` lists as
(kind, payload bytes, group size n) while the step runs.  This module
applies the reference's ring multipliers to those records:

    all-gather        (n-1)/n * result_bytes       per device through a link
    reduce-scatter    (n-1)/n * operand_bytes
    all-reduce        2 (n-1)/n * operand_bytes    (RS + AG)
    all-to-all        (n-1)/n * operand_bytes
    collective-permute  operand_bytes              (one neighbour hop)

with n at least 2, as the reference takes it.  The port issues no
reduce-scatter of its own (`collectives.reduce_scatter` is an all-reduce
and a cut, recorded as the all-reduce) and no all-to-all.  Orthogonal-axis
collectives could use disjoint links concurrently; like the reference,
this serializes them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Tuple

__all__ = ["collective_stats", "link_bytes"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def link_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes one device moves through a link for one collective of `kind`
    with `payload` bytes over a group of n (the reference's multipliers)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")
    frac = (max(n, 2) - 1) / max(n, 2)
    if kind == "all-reduce":
        return 2 * frac * payload
    if kind == "collective-permute":
        return float(payload)
    return frac * payload


def collective_stats(records: Iterable[Tuple[str, int, int]]) -> Dict[str, Dict[str, float]]:
    """{kind: {"count", "payload_bytes", "link_bytes"}} (per device) of the
    (kind, payload bytes, n) records, the reference's result format."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "payload_bytes": 0.0, "link_bytes": 0.0})
    for kind, payload, n in records:
        s = stats[kind]
        s["count"] += 1
        s["payload_bytes"] += float(payload)
        s["link_bytes"] += link_bytes(kind, payload, n)
    return dict(stats)
