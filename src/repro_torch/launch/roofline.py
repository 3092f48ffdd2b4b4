"""Roofline terms of one GEMM plan on one NVIDIA H100.

Port of `repro.launch.roofline.analyze_plan`:

    compute term    = plan FLOPs / peak FLOP/s                    [s]
    memory term     = HBM bytes (each operand read once, the
                      output written once) / HBM bandwidth         [s]
    collective term = collective bytes / link bandwidth            [s]

at the data-sheet rates of one H100 SXM (`costmodel.model`): 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s HBM3, 450 GB/s of NVLink each
way.  The reference's `analyze_artifact` / `analyze_dir`, which read the
XLA dry-run artifacts of `launch/dryrun.py`, arrive with that module's
counterpart.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.costmodel.model import (
    H100_BF16_FLOPS,
    H100_HBM_BYTES_PER_S,
    H100_NVLINK_BYTES_PER_S,
    terms_from_describe,
)

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "analyze_plan"]

PEAK_FLOPS = H100_BF16_FLOPS  # bf16 FLOP/s per card
HBM_BW = H100_HBM_BYTES_PER_S  # bytes/s per card
LINK_BW = H100_NVLINK_BYTES_PER_S  # bytes/s each way between two cards

_HINTS = {
    "compute": "reduce recompute (remat policy) / pick a lower-waste schedule — the plan's FLOPs exceed the useful-model floor",
    "memory": "raise arithmetic intensity: fuse ops, larger tiles, avoid streaming weights/caches more than once",
    "collective": "reshard to cut link traffic: different TP axis placement, overlap/ring schedules, gradient compression",
    "collective(hidden)": "collective is the largest term but the schedule double-buffers it behind kernel calls — already hidden; cut link bytes to go faster",
}


def analyze_plan(desc: Dict[str, Any]) -> Dict[str, Any]:
    """Roofline terms for ONE GEMM plan from its `Plan.describe()` record —
    per card, per call, at the H100 constants.

    Grouped plans (a "grouped" provenance record) decompose into per-group
    compute terms — rows stream once but every group's weight slab streams
    — plus the dispatch (scatter/gather routing) bytes; unknown record
    shapes degrade to the plain-GEMM arithmetic instead of raising.  The
    byte/FLOP arithmetic lives in `costmodel.model.terms_from_describe` (the
    `terms` dict is echoed back in the result); this function adds the
    constants, the dominant-term classification and tuning hints.
    """
    sh = desc.get("sharding") or {}
    grp = desc.get("grouped") or {}
    t = terms_from_describe(desc)
    flops, hbm_bytes, coll_bytes = t["flops"], t["hbm_bytes"], t["collective_bytes"]
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": hbm_bytes / HBM_BW,
        "collective": coll_bytes / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    overlap = bool(t.get("overlap"))
    # An overlapped schedule hides the collective behind kernel calls: the
    # bound is the max of all three terms, and a collective-dominant plan
    # gets the "already hidden" hint instead of the reshard one.
    if overlap:
        t_total = max(terms.values())
        hint_key = "collective(hidden)" if dominant == "collective" else dominant
    else:
        t_total = max(terms["compute"], terms["memory"]) + terms["collective"]
        hint_key = dominant
    out = {
        "backend": desc["backend"],
        "mkn": desc["mkn"],
        "schedule": sh.get("schedule"),
        "overlap": overlap,
        "per_shard_flops": flops,
        "hbm_bytes": hbm_bytes,
        "collective_bytes": coll_bytes,
        "terms": t,
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": dominant,
        "t_bound_s": terms[dominant],
        "t_total_s": t_total,
        "hint": _HINTS[hint_key],
    }
    if grp:
        out["grouped"] = {
            "num_groups": grp.get("num_groups"),
            "rows_per_group": grp.get("rows_per_group"),
            "per_group_flops": grp.get("per_group_flops"),
            "per_group_t_compute_s": grp.get("per_group_flops", 0) / PEAK_FLOPS,
            "dispatch_bytes": grp.get("dispatch_bytes", 0),
            "t_dispatch_s": grp.get("dispatch_bytes", 0) / HBM_BW,
        }
    return out
