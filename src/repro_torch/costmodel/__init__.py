"""Cost-model subsystem: the planner's brain.

Port of `repro.costmodel`.  `model` turns a plan's describe() record into
roofline terms and predicted seconds under per-platform coefficients
(`cpu`, `cuda`); `calibrate` fits those coefficients from measured probes
(versioned `.costmodel_cache.json`); `choose` ranks candidate backends and
block shapes for `kernels.api.plan()` and records the decision provenance.
"""

from repro_torch.costmodel.calibrate import (
    CALIBRATION_VERSION,
    CalibrationCache,
    calibrate,
    clear_coefficients_memo,
    current_coefficients,
    default_cache,
    default_platform,
    fit_coefficients,
    ingest,
    run_probes,
)
from repro_torch.costmodel.choose import (
    Decision,
    NoLegalCandidate,
    choose_blocks,
    clear_decision_memo,
    decide_backend,
)
from repro_torch.costmodel.model import (
    COST_MODEL_VERSION,
    CostCoefficients,
    default_coefficients,
    predict,
    predict_blocks_ms,
    repeat_amortization,
    structure_step_factor,
    terms_from_describe,
)

__all__ = [
    "CALIBRATION_VERSION",
    "COST_MODEL_VERSION",
    "CalibrationCache",
    "CostCoefficients",
    "Decision",
    "NoLegalCandidate",
    "calibrate",
    "choose_blocks",
    "clear_coefficients_memo",
    "clear_decision_memo",
    "current_coefficients",
    "decide_backend",
    "default_cache",
    "default_coefficients",
    "default_platform",
    "fit_coefficients",
    "ingest",
    "predict",
    "predict_blocks_ms",
    "repeat_amortization",
    "run_probes",
    "structure_step_factor",
    "terms_from_describe",
]
