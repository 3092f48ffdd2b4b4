"""Roofline terms on one NVIDIA H100: of one GEMM plan, and of the dry
runs' artifacts (port of `repro.launch.roofline`).

Per plan (`analyze_plan`):

    compute term    = plan FLOPs / peak FLOP/s                    [s]
    memory term     = HBM bytes (each operand read once, the
                      output written once) / HBM bandwidth         [s]
    collective term = collective bytes / link bandwidth            [s]

Per dry-run cell (`analyze_artifact`, reading
artifacts/torch/<mesh>/<arch>__<shape>.json from `launch/dryrun.py`):

    compute term    = FLOPs_per_device / peak_FLOPs               [s]
    memory term     = bytes_per_device / HBM_bw                   [s]
    collective term = collective_link_bytes_per_device / link_bw  [s]

    MODEL_FLOPS  = 6·N·D (train, dense) / 6·N_active·D (train, MoE)
                   2·N(_active)·D for inference steps (fwd only)
    useful ratio = MODEL_FLOPS / (FLOPs · n_devices)
    roofline fraction = t_model / max(terms)
        where t_model = MODEL_FLOPS / (n_devices · peak).

all at the data-sheet rates of one H100 SXM (`costmodel.model`): 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 450 GB/s of
NVLink each way.  These are counts of the port's eager step over rates,
not measurements.  The port's FLOPs are products only, so its useful ratio
reads higher than the reference's XLA count (`launch/dryrun.py`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/torch/pod16x16]
        [--md roofline.md] [--json roofline.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.costmodel.model import (
    H100_BF16_FLOPS,
    H100_HBM_BYTES_PER_S,
    H100_NVLINK_BYTES_PER_S,
    terms_from_describe,
)

__all__ = [
    "HBM_BW",
    "LINK_BW",
    "PEAK_FLOPS",
    "analyze_artifact",
    "analyze_dir",
    "analyze_plan",
    "model_flops",
    "render_markdown",
]

PEAK_FLOPS = H100_BF16_FLOPS  # bf16 FLOP/s per card
HBM_BW = H100_HBM_BYTES_PER_S  # bytes/s per card
LINK_BW = H100_NVLINK_BYTES_PER_S  # bytes/s each way between two cards

_HINTS = {
    "compute": "reduce recompute (remat policy) / pick a lower-waste schedule — the plan's FLOPs exceed the useful-model floor",
    "memory": "raise arithmetic intensity: fuse ops, larger tiles, avoid streaming weights/caches more than once",
    "collective": "reshard to cut link traffic: different TP axis placement, overlap/ring schedules, gradient compression",
    "collective(hidden)": "collective is the largest term but the schedule double-buffers it behind kernel calls — already hidden; cut link bytes to go faster",
}


def model_flops(art: Dict[str, Any]) -> float:
    """Useful-model FLOPs per step for the cell (whole job, not per device)."""
    n_active = art.get("n_active_params") or art.get("n_params") or 0
    kind = art.get("kind", "train")
    tokens = art.get("tokens_per_step")
    if tokens is None:
        # Reconstruct from the shape registry (artifacts without the
        # tokens_per_step field).
        from repro_torch.configs import SHAPES

        sh = SHAPES[art["shape"]]
        tokens = sh.global_batch * (sh.seq_len if kind in ("train", "prefill") else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def analyze_artifact(art: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Compute roofline terms for one artifact dict; None for skipped cells.

    Reads the reference's artifacts too: their probe-corrected costs plus
    `recurrence_bytes_analytic`.  The port's trace already holds the
    recurrent-state traffic (`recurrence_bytes_in_trace`), so it is not
    added twice."""
    if art.get("status") != "ok":
        return None
    n_dev = art["n_devices"]
    flops = art.get("flops_per_device_corrected", art["flops_per_device"])
    byts = art.get("bytes_per_device_corrected", art["bytes_per_device"])
    if not art.get("recurrence_bytes_in_trace"):
        byts += art.get("recurrence_bytes_analytic", 0.0)
    coll = art.get(
        "collective_link_bytes_corrected", art.get("collective_link_bytes", 0.0)
    )
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(art)
    t_model = mf / (n_dev * PEAK_FLOPS)
    hlo_total = flops * n_dev
    return {
        "arch": art["arch"],
        "shape": art["shape"],
        "mesh": art["mesh"],
        "kind": art["kind"],
        "n_devices": n_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "t_bound_s": terms[dominant],
        "model_flops": mf,
        "useful_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "roofline_fraction": (t_model / terms[dominant]) if terms[dominant] else 0.0,
        "hint": _HINTS[dominant],
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


def analyze_dir(path: str) -> List[Dict[str, Any]]:
    rows, skips = [], []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            art = json.load(fh)
        if not isinstance(art, dict) or "arch" not in art:
            continue
        r = analyze_artifact(art)
        if r is None:
            skips.append({"arch": art["arch"], "shape": art["shape"],
                          "status": art.get("status"),
                          "reason": art.get("reason", art.get("error", ""))})
        else:
            rows.append(r)
    return rows + [{"skip": True, **s} for s in skips]


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def render_markdown(rows: List[Dict[str, Any]], title: str = "") -> str:
    out = []
    if title:
        out.append(f"### {title}\n")
    out.append("| arch | shape | compute | memory | collective | dominant | useful FLOP ratio |"
               " roofline frac |")
    out.append("|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r.get("skip"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | {r['status'].upper()} | — |"
                       f" {r.get('reason', '')[:60]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} "
            f"| {_fmt_s(r['t_collective_s'])} | **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} |"
        )
    return "\n".join(out) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("artifacts", "torch", "pod16x16"))
    ap.add_argument("--md", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    rows = analyze_dir(args.dir)
    md = render_markdown(rows, title=f"Roofline — {args.dir}")
    print(md)
    live = [r for r in rows if not r.get("skip")]
    if live:
        worst = min(live, key=lambda r: r["roofline_fraction"])
        collb = [r for r in live if r["dominant"] == "collective"]
        print(f"worst roofline fraction: {worst['arch']} x {worst['shape']} ="
              f" {worst['roofline_fraction']:.3f}")
        print(f"collective-bound cells: {[(r['arch'], r['shape']) for r in collb]}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
