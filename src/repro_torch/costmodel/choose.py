"""Candidate enumeration + cost-ranked choice for the planner.

Port of `repro.costmodel.choose`.  `kernels/api.plan()` consults this
module whenever a degree of freedom is left unspecified:

  decide_backend    rank the capability-legal backends by predicted cost
                    (per-platform `backend_efficiency`); the caller's
                    legacy preference order is the deterministic tie-break
  choose_blocks     block triples stay with `kernels/autotune.py`; once
                    coefficients are CALIBRATED the autotuner's candidate
                    ranking switches to `predict_blocks_ms` (its timed
                    search remains the tie-breaker on the card)

The reference's `decide_schedule` and `decide_sharding` rank `ShardSpec`
collective schedules and axis assignments; they arrive with the port of
`ShardSpec` (distribution).

Every decision returns a JSON-able `Decision` recorded in
`Plan.describe()["decision"]`: the chosen candidate, every candidate's
predicted seconds, and the calibration provenance — so
`launch/serve.py --plan-stats` and the ledger can show *why*.  Rankings use
`calibrate.current_coefficients(platform)` and are deterministic for a
fixed calibration file: pure arithmetic, no timing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.costmodel.calibrate import current_coefficients
from repro_torch.costmodel.model import (
    COST_MODEL_VERSION,
    CostCoefficients,
    predict,
    predict_blocks_ms,
    terms_from_describe,
)

__all__ = [
    "Decision",
    "NoLegalCandidate",
    "choose_blocks",
    "clear_decision_memo",
    "decide_backend",
]


class NoLegalCandidate(Exception):
    """No candidate survived legality trials — the caller falls back to its
    legacy resolution (which raises the precise validation error)."""


@dataclasses.dataclass
class Decision:
    """Provenance of one cost-model choice, as recorded in describe()."""

    kind: str  # "backend" | "blocks"
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
    """Test hook: the reference drops its sharding-decision memo here; the
    port has no memo until `decide_sharding` is ported."""
