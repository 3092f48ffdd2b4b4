"""Candidate enumeration + cost-ranked choice for the planner.

Port of `repro.costmodel.choose`.  `kernels/api.plan()` consults this
module whenever a degree of freedom is left unspecified:

  decide_schedule   ShardSpec.schedule == "auto" with pinned axes: rank
                    every divisibility-LEGAL collective schedule (legality
                    is established by trial `_resolve_sharding` calls with
                    the schedule pinned, so an illegal candidate can never
                    be chosen)
  decide_sharding   plan(spec, mesh=...) with NO ShardSpec: enumerate axis
                    assignments over the mesh (M-replicated, allgather_a,
                    reduce_scatter_k, ring_k, N-replicated, 2D M x N,
                    expert for grouped specs, plus unsharded, and under
                    CALIBRATED coefficients the double-buffered
                    `*_overlap`/`pipeline` family) and return the cheapest
                    legal ShardSpec
  decide_backend    rank the capability-legal backends by predicted cost
                    (per-platform `backend_efficiency`); the caller's
                    legacy preference order is the deterministic tie-break
  choose_blocks     block triples stay with `kernels/autotune.py`; once
                    coefficients are CALIBRATED the autotuner's candidate
                    ranking switches to `predict_blocks_ms` (its timed
                    search remains the tie-breaker on the card)

Every decision returns a JSON-able `Decision` recorded in
`Plan.describe()["decision"]`: the chosen candidate, every candidate's
predicted seconds, and the calibration provenance — so
`launch/serve.py --plan-stats` and the ledger can show *why*.  Rankings use
`calibrate.current_coefficients(platform)` and are deterministic for a
fixed calibration file: pure arithmetic, no timing.  Under
$REPRO_COSTMODEL_TIMED=1 the top two schedule candidates are also timed
through real plan executions and the measurement wins; the reference does
that on its TPU by default, the port only when asked, because the ranks of
one card share it.  Ranks agree on the timed order (the larger of their
readings counts), so every rank plans the same schedule.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.costmodel.calibrate import current_coefficients
from repro_torch.costmodel.model import (
    COST_MODEL_VERSION,
    CostCoefficients,
    predict,
    predict_blocks_ms,
    terms_from_describe,
)
from repro_torch.resilience import ledger as _rledger

__all__ = [
    "Decision",
    "NoLegalCandidate",
    "choose_blocks",
    "clear_decision_memo",
    "decide_backend",
    "decide_schedule",
    "decide_sharding",
]

_ENV_TIMED = "REPRO_COSTMODEL_TIMED"

# Deterministic preference among predicted-cost ties (no collective beats a
# scatter beats a gather beats a full ring wavefront; a serial schedule beats
# its overlap twin at equal prediction, so overlap wins only when calibrated
# link terms say it does).
_SCHED_PREF = (
    "replicated",
    "reduce_scatter_k",
    "allgather_a",
    "ring_k",
    "reduce_scatter_k_overlap",
    "allgather_a_overlap",
    "ring_k_overlap",
    "pipeline",
    "expert",
)


def _is_overlap(sched: str) -> bool:
    """Mirror of `api._is_overlap_schedule` (not imported: api imports this
    module): double-buffered ring schedules priced as max(compute, comm)."""
    return sched.endswith("_overlap") or sched == "pipeline"


class NoLegalCandidate(Exception):
    """No candidate survived legality trials — the caller falls back to its
    legacy resolution (which raises the precise validation error)."""


@dataclasses.dataclass
class Decision:
    """Provenance of one cost-model choice, as recorded in describe()."""

    kind: str  # "schedule" | "sharding" | "backend" | "blocks"
    chosen: str
    candidates: List[Dict[str, Any]]
    calibration: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "chosen": self.chosen,
            "candidates": self.candidates,
            "calibration": self.calibration,
        }


def _stamp(coeffs: CostCoefficients) -> Dict[str, Any]:
    return {
        "model_version": COST_MODEL_VERSION,
        "source": coeffs.source,
        "platform": coeffs.platform,
    }


def _best_backend(coeffs: CostCoefficients) -> Optional[str]:
    """The platform's fastest known GEMM path: schedule and sharding
    rankings are backend-relative, so predicting every candidate at the
    same (best) efficiency keeps absolute numbers honest without biasing
    the order."""
    if not coeffs.backend_efficiency:
        return None
    return max(coeffs.backend_efficiency, key=lambda kv: kv[1])[0]


def _candidate_terms(spec, sched: str, local, bytes_moved: int, phases: int):
    """The describe()-shaped record of a candidate not planned yet, and its
    cost terms (one arithmetic path: `model.terms_from_describe`).  The
    invocation count is `api._build_sharded_plan`'s."""
    from repro_torch.kernels import api as _api

    if sched in ("reduce_scatter_k", "reduce_scatter_k_overlap"):
        inv = phases + 1
    elif sched in ("allgather_a_overlap", "ring_k_overlap"):
        inv = 2  # two column-half products
    elif sched == "pipeline":
        inv = _api._pipeline_microbatches(spec.eff_m, spec.shard.axis_size(spec.shard.axis_k))
    else:
        inv = 1
    desc: Dict[str, Any] = {
        "backend": None,
        "mkn": f"{spec.eff_m}x{spec.k}x{spec.n}",
        "dtypes": [spec.dtype_a, spec.dtype_b],
        "out_dtype": spec.resolved_out_dtype(),
        "flops": spec.flops(),
        "batch": list(spec.batch),
        "batched_b": spec.batched_b,
        "structure": spec.structure,
        "repeats": spec.repeats,
    }
    if spec.group is not None:
        grp = spec.group
        ia = _api._NAME_DTYPES[spec.dtype_a].itemsize
        io = _api._NAME_DTYPES[spec.resolved_out_dtype()].itemsize
        desc["grouped"] = {
            "num_groups": grp.num_groups,
            "rows_per_group": grp.rows_per_group,
            "per_group_flops": 2 * grp.rows_per_group * spec.k * spec.n,
            "dispatch_bytes": grp.rows * (spec.k * ia + spec.n * io),
        }
    shard = spec.shard
    desc["sharding"] = {
        "schedule": sched,
        "overlap": _is_overlap(sched),
        "bytes_moved": bytes_moved,
        "collective_phases": phases,
        "kernel_invocations": inv,
        "per_shard_mkn": [local.eff_m, local.k, local.n],
        "per_shard_batch": list(local.batch),
        "per_shard_flops": local.flops() * inv,
        "mesh": [[n, s] for n, s in shard.mesh_axes],
        "axes": {"m": shard.axis_m, "k": shard.axis_k, "n": shard.axis_n,
                 "batch": shard.axis_batch, "g": shard.axis_g},
    }
    return terms_from_describe(desc)


def _rank(cands: List[Dict[str, Any]], illegal: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    def pref(name: str) -> int:
        base = name.split("[", 1)[0]
        return _SCHED_PREF.index(base) if base in _SCHED_PREF else len(_SCHED_PREF)

    cands.sort(key=lambda c: (c["predicted_s"], pref(c["name"]), c["name"]))
    return cands + illegal


def _evaluate(spec, shard, coeffs, platform) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    """Legality-trial one (spec, pinned-schedule ShardSpec) candidate:
    (candidate record, None) when `_resolve_sharding` accepts it, (None,
    reason) when it raises PlanValidationError.  The trial is the real plan
    build's validation, so legality here IS legality there."""
    from repro_torch.kernels import api

    trial = dataclasses.replace(spec, shard=shard)
    try:
        sched, local, bytes_moved, phases, _ = api._resolve_sharding(trial, platform)
    except api.PlanValidationError as e:
        return None, str(e)
    terms = _candidate_terms(trial, sched, local, bytes_moved, phases)
    pred = predict(terms, coeffs, backend=_best_backend(coeffs))
    overlap = bool(terms.get("overlap"))
    return (
        {
            "name": sched,
            "schedule": sched,
            "predicted_s": pred["total_s"],
            "t_compute_s": pred["t_compute_s"],
            "t_memory_s": pred["t_memory_s"],
            "t_collective_s": pred["t_collective_s"],
            "overlap": overlap,
            "pricing": ("max(compute,memory,collective)+latency" if overlap
                        else "max(compute,memory)+collective+latency"),
            "legal": True,
        },
        None,
    )


def _timed_tiebreak(spec, mesh, ranked: List[Dict[str, Any]], shards: Dict[str, Any],
                    platform: str) -> List[Dict[str, Any]]:
    """Under $REPRO_COSTMODEL_TIMED=1: time the top-2 predicted candidates
    through real plan executions on `platform` and reorder by measurement.
    Every rank of the mesh takes part; each reading is the largest over the
    ranks, so all ranks reorder alike."""
    if os.environ.get(_ENV_TIMED, "") != "1":
        return ranked
    legal = [c for c in ranked if c.get("legal")]
    if len(legal) < 2 or mesh is None:
        return ranked
    import torch.distributed as dist

    from repro_torch.kernels import api
    from repro_torch.kernels.autotune import measure_best_ms

    for cand in legal[:2]:
        shard = shards.get(cand["name"])
        if shard is None:
            continue
        try:
            p = api.plan(dataclasses.replace(spec, shard=shard), mesh=mesh, device=platform)
            dt = api._NAME_DTYPES
            a = torch.ones(spec.batch + (spec.m, spec.k), dtype=dt[spec.dtype_a], device=platform)
            b_shape = spec.batch + (spec.k, spec.n) if spec.batched_b else (spec.k, spec.n)
            b = torch.ones(b_shape, dtype=dt[spec.dtype_b], device=platform)
            ms = torch.tensor(measure_best_ms(p, a, b))
            if dist.is_initialized():
                dist.all_reduce(ms, op=dist.ReduceOp.MAX)
            cand["measured_ms"] = float(ms)
        except Exception as e:
            _rledger.record("costmodel.tiebreak", cause=f"{type(e).__name__}: {e}",
                            fallback="model-order", candidate=cand["name"])
    timed = [c for c in legal[:2] if "measured_ms" in c]
    if len(timed) == 2 and (
        (timed[0]["measured_ms"] > timed[1]["measured_ms"])
        != (timed[0]["predicted_s"] > timed[1]["predicted_s"])
    ):
        legal[0], legal[1] = legal[1], legal[0]
        return legal + [c for c in ranked if not c.get("legal")]
    return ranked


def decide_schedule(spec, mesh=None, *, platform: Optional[str] = None) -> Tuple[str, Decision]:
    """Resolve `schedule="auto"` for a spec with PINNED shard axes.

    Candidates are the non-expert SCHEDULES (expert belongs to grouped
    specs); each is legality-trialed with the schedule pinned and the
    survivors are ranked by predicted cost on `platform`.  The overlap
    family (`*_overlap` / `pipeline`) enters the candidate set only under
    CALIBRATED coefficients: with shipped defaults (zero latency terms) its
    max(compute, comm) pricing would beat every serial schedule
    unconditionally.  Pinning an overlap schedule explicitly always works.
    Raises NoLegalCandidate when nothing survives, so the caller's legacy
    heuristic can raise its precise validation error.
    """
    from repro_torch.kernels import api

    coeffs = current_coefficients(platform)
    platform = coeffs.platform
    overlap_ok = coeffs.source == "calibrated"
    shard = spec.shard
    cands: List[Dict[str, Any]] = []
    illegal: List[Dict[str, Any]] = []
    shards: Dict[str, Any] = {}
    for sched in (s for s in api.SCHEDULES if s != "expert"):
        if _is_overlap(sched) and not overlap_ok:
            continue
        pinned = dataclasses.replace(shard, schedule=sched)
        cand, reason = _evaluate(spec, pinned, coeffs, platform)
        if cand is not None:
            cands.append(cand)
            shards[cand["name"]] = pinned
        else:
            illegal.append({"name": sched, "legal": False, "reason": reason[:120]})
    if not cands:
        raise NoLegalCandidate(f"no legal collective schedule for shard axes of {spec!r}")
    ranked = _timed_tiebreak(spec, mesh, _rank(cands, illegal), shards, platform)
    chosen = ranked[0]["name"]
    return chosen, Decision("schedule", chosen, ranked, _stamp(coeffs))


def _sharding_candidates(spec, mesh, *, overlap_ok: bool = False) -> List[Tuple[str, Any]]:
    """(label, ShardSpec) axis assignments to trial over the mesh; the
    schedule is pinned so a trial never re-enters auto resolution.
    `overlap_ok` admits the double-buffered family (calibrated
    coefficients only, as in `decide_schedule`)."""
    from repro_torch.kernels.api import ShardSpec
    from repro_torch.parallel.sharding import mesh_shape

    axes = list(mesh_shape(mesh).items())
    out: List[Tuple[str, Any]] = [("unsharded", ShardSpec.from_mesh(mesh, schedule="replicated"))]
    if spec.group is not None:
        for name, size in axes:
            if size > 1:
                out.append((f"expert[g={name}]",
                            ShardSpec.from_mesh(mesh, g=name, schedule="expert")))
        return out
    for name, size in axes:
        if size <= 1:
            continue
        out.extend([
            (f"replicated[m={name}]", ShardSpec.from_mesh(mesh, m=name, schedule="replicated")),
            (f"allgather_a[m={name}]", ShardSpec.from_mesh(mesh, m=name, schedule="allgather_a")),
            (f"reduce_scatter_k[k={name}]",
             ShardSpec.from_mesh(mesh, k=name, schedule="reduce_scatter_k")),
            (f"ring_k[k={name}]", ShardSpec.from_mesh(mesh, k=name, schedule="ring_k")),
            (f"replicated[n={name}]", ShardSpec.from_mesh(mesh, n=name, schedule="replicated")),
        ])
        if overlap_ok:
            out.extend([
                (f"reduce_scatter_k_overlap[k={name}]",
                 ShardSpec.from_mesh(mesh, k=name, schedule="reduce_scatter_k_overlap")),
                (f"allgather_a_overlap[m={name}]",
                 ShardSpec.from_mesh(mesh, m=name, schedule="allgather_a_overlap")),
                (f"ring_k_overlap[k={name}]",
                 ShardSpec.from_mesh(mesh, k=name, schedule="ring_k_overlap")),
                (f"pipeline[k={name}]", ShardSpec.from_mesh(mesh, k=name, schedule="pipeline")),
            ])
        if spec.batched_b:
            out.append((f"replicated[batch={name}]",
                        ShardSpec.from_mesh(mesh, batch=name, schedule="replicated")))
    if len(axes) >= 2 and not spec.batched_b:
        (a0, _), (a1, _) = axes[0], axes[1]
        out.append((f"replicated[m={a0},n={a1}]",
                    ShardSpec.from_mesh(mesh, m=a0, n=a1, schedule="replicated")))
    return out


_SHARD_MEMO: Dict[tuple, Tuple[Any, Decision]] = {}


def decide_sharding(spec, mesh, *, platform: Optional[str] = None) -> Tuple[Any, Decision]:
    """Choose a full ShardSpec (axes AND schedule) for a spec with none.

    This is where reduce_scatter_k outranks allgather_a: the gather
    schedule runs the FULL-K per-shard product where the scatter runs K/p
    slabs, for the same bytes moved.  Memoized per (spec, mesh axes,
    platform, coefficients).
    """
    from repro_torch.parallel.sharding import mesh_shape

    coeffs = current_coefficients(platform)
    platform = coeffs.platform
    memo_key = (spec, tuple(mesh_shape(mesh).items()), platform, coeffs)
    got = _SHARD_MEMO.get(memo_key)
    if got is not None:
        return got
    cands: List[Dict[str, Any]] = []
    illegal: List[Dict[str, Any]] = []
    shards: Dict[str, Any] = {}
    overlap_ok = coeffs.source == "calibrated"
    for label, shard in _sharding_candidates(spec, mesh, overlap_ok=overlap_ok):
        cand, reason = _evaluate(spec, shard, coeffs, platform)
        if cand is not None:
            cand["name"] = label
            cands.append(cand)
            shards[label] = shard
        else:
            illegal.append({"name": label, "legal": False, "reason": reason[:120]})
    if not cands:
        raise NoLegalCandidate(
            f"no legal axis assignment for {spec!r} on mesh {mesh_shape(mesh)}")
    ranked = _timed_tiebreak(spec, mesh, _rank(cands, illegal), shards, platform)
    chosen = ranked[0]["name"]
    got = (shards[chosen], Decision("sharding", chosen, ranked, _stamp(coeffs)))
    _SHARD_MEMO[memo_key] = got
    return got


def decide_backend(
    spec, candidates: Sequence[Tuple[str, int]], *, platform: Optional[str] = None
) -> Tuple[str, Decision]:
    """Rank capability-legal backends by predicted cost on `platform`.

    `candidates` is [(name, legacy_order_index)] — the index is the
    deterministic tie-break, so equal predictions reproduce the legacy
    pinned-default -> torch -> cuda_mesh -> registration order exactly.
    """
    coeffs = current_coefficients(platform)
    desc = {
        "backend": None,
        "mkn": f"{spec.eff_m}x{spec.k}x{spec.n}",
        "dtypes": [spec.dtype_a, spec.dtype_b],
        "out_dtype": spec.resolved_out_dtype(),
        "flops": spec.flops(),
        "batch": list(spec.batch),
        "batched_b": spec.batched_b,
        "structure": spec.structure,
        "repeats": spec.repeats,
    }
    terms = terms_from_describe(desc)
    rows = []
    for name, order in candidates:
        pred = predict(terms, coeffs, backend=name)
        rows.append(
            {
                "name": name,
                "predicted_s": pred["total_s"],
                "efficiency": coeffs.efficiency(name),
                "legal": True,
                "_order": order,
            }
        )
    rows.sort(key=lambda r: (r["predicted_s"], r["_order"]))
    for r in rows:
        del r["_order"]
    chosen = rows[0]["name"]
    return chosen, Decision("backend", chosen, rows, _stamp(coeffs))


def choose_blocks(
    m: int, k: int, n: int, dtype, backend: str, *, symmetry: int = 0,
    platform: Optional[str] = None,
):
    """Resolve the block triple, consulting the cost model once calibrated.

    With shipped-default coefficients this IS `autotune.resolve_blocks`
    (identical choice, identical caching).  With CALIBRATED coefficients
    the candidate ranking switches to `predict_blocks_ms` under the same
    cache and timed-search tie-break.  Returns (blocks, decision | None).
    """
    from repro_torch.kernels import autotune as _autotune

    coeffs = current_coefficients(platform)
    if coeffs.source != "calibrated":
        return _autotune.resolve_blocks(
            m, k, n, dtype, backend, symmetry=symmetry, platform=platform
        ), None
    blocks = _autotune.autotune(
        m,
        k,
        n,
        dtype,
        backend,
        symmetry=symmetry,
        platform=platform,
        scorer=lambda blk: predict_blocks_ms(m, k, n, blk, coeffs),
    )
    decision = Decision(
        "blocks",
        "x".join(map(str, blocks)),
        [
            {
                "name": "x".join(map(str, blocks)),
                "predicted_s": predict_blocks_ms(m, k, n, blocks, coeffs) / 1e3,
                "legal": True,
            }
        ],
        _stamp(coeffs),
    )
    return blocks, decision


def clear_decision_memo() -> None:
    """Test hook: drop the per-process sharding-decision memo."""
    _SHARD_MEMO.clear()
