"""Measured calibration of the cost-model coefficients.

Port of `repro.costmodel.calibrate`.  `calibrate()` times a small probe set
through the ordinary plan/execute path (`kernels.api.plan` + the
autotuner's `measure_best_ms`, which times the device on the card), then
fits `CostCoefficients` to the measurements with a deterministic
coordinate-descent hillclimb.  Fitted coefficients persist to a versioned
`.costmodel_cache.json` in the reference's format, with its resilience
contract: an unreadable file is QUARANTINED to `<path>.corrupt` (warned
once, ledger-recorded), invalid entries are dropped on load, and saves are
bounded-retry best-effort.

Platforms are device types (`cpu`, `cuda`), so a record the reference
wrote for another platform (`tpu`, `gpu`) is never fitted to the card.  A
file the reference wrote reads here with its backend names mapped (`xla`
-> `torch`, `pallas_mesh` -> `cuda_mesh`), in the coefficients' backend
efficiencies and in each record's terms and key.

The record format is shared currency: `launch/hillclimb.py --gemm` writes
its measurements as the same `{"terms": ..., "ms": ..., "source": ...}`
dicts, and so does the obs bridge (`obs/bridge.py`), whose records of
card executions carry device time from CUDA events; `ingest()` folds them
into the calibration file.

`current_coefficients()` is the planner's read path: calibrated numbers if
the file has them for this platform, shipped defaults otherwise — memoized
per process so plan-time decisions never touch the filesystem twice
(`launch/scheduler.warmup` preloads it so no serving tick pays the read).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import warnings
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.costmodel.model import (
    COST_MODEL_VERSION,
    CostCoefficients,
    default_coefficients,
    predict,
    terms_from_describe,
)
from repro_torch.obs import trace as _obs
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import ledger as _rledger
from repro_torch.resilience.policy import retry_call as _retry_call

__all__ = [
    "CALIBRATION_VERSION",
    "CalibrationCache",
    "calibrate",
    "clear_coefficients_memo",
    "current_coefficients",
    "default_cache",
    "default_platform",
    "fit_coefficients",
    "ingest",
    "run_probes",
]

CALIBRATION_VERSION = 1
DEFAULT_CACHE_FILENAME = ".costmodel_cache.json"
_ENV_CACHE = "REPRO_COSTMODEL_CACHE"

# Probe GEMMs: small enough for CI, spread enough to separate the FLOP
# term (large cube) from fixed launch overhead (tiny cube).
PROBE_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 64),
    (128, 128, 128),
    (256, 256, 256),
    (512, 512, 512),
)

# The reference's backend names, and the port's for the same backends.
BACKEND_NAMES = {"xla": "torch", "pallas_mesh": "cuda_mesh",
                 "pallas_mesh_scrambled": "cuda_mesh_scrambled"}

_FIT_FIELDS = (
    "flops_per_s",
    "hbm_bytes_per_s",
    "link_bytes_per_s",
    "phase_latency_s",
    "launch_overhead_s",
)


def _valid_record(rec: Any) -> bool:
    return (
        isinstance(rec, dict)
        and isinstance(rec.get("terms"), dict)
        and isinstance(rec.get("ms"), (int, float))
        and rec["ms"] > 0
        and isinstance(rec["terms"].get("flops"), (int, float))
    )


class CalibrationCache:
    """Versioned persistent JSON store of fitted coefficients + records.

    On-disk format (v1):
        {"version": 1,
         "model_version": 1,
         "coefficients": {platform: {<CostCoefficients fields>}},
         "records": {platform: [{"terms": {...}, "ms": float,
                                 "source": "probe|hillclimb|bench", ...}]}}

    Resilience mirrors `kernels.autotune.AutotuneCache` (DESIGN.md §11):
    corrupt files are quarantined to `<path>.corrupt` with a one-shot
    warning and a ledger record; entries failing validation are dropped
    (recalibration rebuilds them); saves retry and then swallow OSError.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path or os.environ.get(_ENV_CACHE, DEFAULT_CACHE_FILENAME))
        self._doc: Optional[Dict[str, Any]] = None

    # -- persistence ---------------------------------------------------------

    def _quarantine_file(self, err: BaseException) -> None:
        corrupt = Path(str(self.path) + ".corrupt")
        moved = False
        try:
            os.replace(self.path, corrupt)
            moved = True
        except OSError:
            pass
        _warn_once(
            f"costmodel calibration cache {self.path} is unreadable"
            f" ({type(err).__name__}: {err});"
            + (f" moved aside to {corrupt};" if moved else "")
            + " falling back to default coefficients"
        )
        _rledger.record(
            "costmodel.cache_load",
            cause=f"{type(err).__name__}: {err}",
            fallback="quarantine",
            path=str(self.path),
            moved_to=str(corrupt) if moved else None,
        )

    def _load(self) -> Dict[str, Any]:
        if self._doc is not None:
            return self._doc
        self._doc = {"coefficients": {}, "records": {}}
        try:
            _faults.check("costmodel.cache_load", path=str(self.path))
            raw = json.loads(self.path.read_text())
        except FileNotFoundError:
            return self._doc  # first run: nothing to load, nothing to warn
        except (OSError, json.JSONDecodeError, _faults.FaultError) as e:
            self._quarantine_file(e)
            return self._doc
        if not isinstance(raw, dict) or raw.get("version") != CALIBRATION_VERSION:
            # unknown version: start clean — stale fits must not steer plans
            return self._doc
        dropped = 0
        for plat, cd in (raw.get("coefficients") or {}).items():
            try:
                co = CostCoefficients.from_dict(_mapped_coefficients({**cd, "platform": plat}))
                if min(co.flops_per_s, co.hbm_bytes_per_s, co.link_bytes_per_s) <= 0:
                    raise ValueError("non-positive throughput coefficient")
            except (TypeError, ValueError):
                dropped += 1
                continue
            self._doc["coefficients"][plat] = co.as_dict()
        for plat, recs in (raw.get("records") or {}).items():
            keep = ([_mapped_record(r) for r in recs if _valid_record(r)]
                    if isinstance(recs, list) else [])
            dropped += (len(recs) if isinstance(recs, list) else 1) - len(keep)
            if keep:
                self._doc["records"][plat] = keep
        if dropped:
            _warn_once(
                f"costmodel calibration cache {self.path}: dropped {dropped}"
                f" invalid entr{'y' if dropped == 1 else 'ies'}"
            )
            _rledger.record(
                "costmodel.cache_load",
                cause=f"{dropped} entries failed validation",
                fallback="recalibrate",
                path=str(self.path),
            )
        return self._doc

    def save(self) -> None:
        doc = self._load()
        payload = {
            "version": CALIBRATION_VERSION,
            "model_version": COST_MODEL_VERSION,
            "coefficients": doc["coefficients"],
            "records": doc["records"],
        }

        def _write_once() -> None:
            tmp = None
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=str(self.path.parent), prefix=self.path.name, suffix=".tmp"
                )
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                raise

        try:
            _retry_call(
                _write_once,
                retries=2,
                base_delay=0.01,
                retry_on=(OSError,),
                site="costmodel.cache_save",
            )
        except OSError:
            pass

    # -- access --------------------------------------------------------------

    def coefficients(self, platform: str) -> Optional[CostCoefficients]:
        cd = self._load()["coefficients"].get(platform)
        if cd is None:
            return None
        return CostCoefficients.from_dict(
            {**cd, "platform": platform, "source": "calibrated"}
        )

    def set_coefficients(self, coeffs: CostCoefficients) -> None:
        payload = coeffs.as_dict()
        payload["source"] = "calibrated"
        self._load()["coefficients"][coeffs.platform] = payload

    def records(self, platform: str) -> List[Dict[str, Any]]:
        return list(self._load()["records"].get(platform, []))

    def add_records(self, platform: str, recs: Sequence[Mapping[str, Any]]) -> int:
        """Append valid records (invalid ones are counted and skipped)."""
        good = [dict(r) for r in recs if _valid_record(r)]
        if good:
            self._load()["records"].setdefault(platform, []).extend(good)
        return len(good)


def _mapped_coefficients(cd: Dict[str, Any]) -> Dict[str, Any]:
    be = cd.get("backend_efficiency")
    if isinstance(be, Mapping):
        cd["backend_efficiency"] = {BACKEND_NAMES.get(k, k): v for k, v in be.items()}
    return cd


def _mapped_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A record with the reference's backend names mapped to the port's."""
    rec = dict(rec)
    terms = rec["terms"]
    if terms.get("backend") in BACKEND_NAMES:
        rec["terms"] = {**terms, "backend": BACKEND_NAMES[terms["backend"]]}
    key = rec.get("key")
    if isinstance(key, str) and "|" in key:
        head, be = key.rsplit("|", 1)
        rec["key"] = f"{head}|{BACKEND_NAMES.get(be, be)}"
    return rec


_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


_DEFAULT_CACHE: Optional[CalibrationCache] = None


def default_platform() -> str:
    """The platform a caller that names none calibrates and plans for: the
    card when this process has one, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def default_cache() -> CalibrationCache:
    """Process-wide cache instance (respects $REPRO_COSTMODEL_CACHE)."""
    global _DEFAULT_CACHE
    want = Path(os.environ.get(_ENV_CACHE, DEFAULT_CACHE_FILENAME))
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != want:
        _DEFAULT_CACHE = CalibrationCache()
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# Probes + fitting
# ---------------------------------------------------------------------------


def run_probes(
    shapes: Sequence[Tuple[int, int, int]] = PROBE_SHAPES,
    *,
    backend: Optional[str] = None,
    reps: int = 3,
    platform: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Time the probe GEMMs through the plan/execute path on `platform`'s
    device.

    Each probe builds (or cache-hits) an ordinary `api.plan` and times the
    raw executor with `autotune.measure_best_ms` (device time on the card).
    A probe that fails to build or run is skipped with a ledger record;
    calibration degrades to fewer points instead of crashing.
    """
    from repro_torch.kernels import api
    from repro_torch.kernels.autotune import measure_best_ms

    device = platform or default_platform()
    records: List[Dict[str, Any]] = []
    for m, k, n in shapes:
        try:
            spec = api.GemmSpec(m=m, k=k, n=n)
            p = api.plan(spec, backend=backend, device=device)
            a = torch.ones((m, k), dtype=torch.float32, device=device)
            b = torch.ones((k, n), dtype=torch.float32, device=device)
            with _obs.span("calibrate.probe", mkn=f"{m}x{k}x{n}",
                           backend=p.backend):
                ms = measure_best_ms(p.executor, a, b, None, None, reps=reps)
        except Exception as e:
            _rledger.record(
                "costmodel.probe",
                cause=f"{type(e).__name__}: {e}",
                fallback="skip-probe",
                mkn=f"{m}x{k}x{n}",
            )
            continue
        records.append(
            {
                "terms": terms_from_describe(p.describe()),
                "ms": ms,
                "source": "probe",
                "key": f"{m}x{k}x{n}|{p.backend}",
            }
        )
    return records


def _fit_error(
    records: Sequence[Mapping[str, Any]], coeffs: CostCoefficients
) -> float:
    """Mean |log(predicted / measured)| — scale-free, so a 2x miss on a 50us
    probe weighs the same as a 2x miss on a 5ms one."""
    err = 0.0
    for rec in records:
        pred = predict(rec["terms"], coeffs)["total_s"]
        meas = rec["ms"] / 1e3
        err += abs(math.log(max(pred, 1e-12) / meas))
    return err / max(1, len(records))


def fit_coefficients(
    records: Sequence[Mapping[str, Any]],
    *,
    init: Optional[CostCoefficients] = None,
    platform: Optional[str] = None,
    rounds: int = 4,
) -> CostCoefficients:
    """Deterministic coordinate-descent hillclimb over the coefficients.

    One coefficient moves at a time by a fixed multiplicative step ladder
    (latency terms that start at zero get an absolute seed ladder instead);
    only strict error improvements are kept, so the fit is reproducible for
    a fixed record list and coefficients a record set never exercises
    (e.g. link bandwidth with no collective probes) keep their defaults.
    """
    import dataclasses

    coeffs = init or default_coefficients(platform)
    if platform is not None:
        coeffs = dataclasses.replace(coeffs, platform=platform)
    if not records:
        return coeffs
    best_err = _fit_error(records, coeffs)
    steps = (4.0, 2.0, 1.4, 1.15)
    zero_seeds = (1e-6, 1e-5, 1e-4, 1e-3)
    for _ in range(rounds):
        improved = False
        for field in _FIT_FIELDS:
            cur = getattr(coeffs, field)
            cands = list(zero_seeds) if cur == 0 else [
                cur * f for f in steps
            ] + [cur / f for f in steps]
            for cand in cands:
                trial = dataclasses.replace(coeffs, **{field: cand})
                err = _fit_error(records, trial)
                if err < best_err - 1e-12:
                    coeffs, best_err, improved = trial, err, True
        if not improved:
            break
    return dataclasses.replace(coeffs, source="calibrated")


def calibrate(
    *,
    platform: Optional[str] = None,
    cache: Optional[CalibrationCache] = None,
    shapes: Sequence[Tuple[int, int, int]] = PROBE_SHAPES,
    backend: Optional[str] = None,
    persist: bool = True,
) -> CostCoefficients:
    """Probe, fit, persist, and install the platform's coefficients."""
    platform = platform or default_platform()
    cache = cache or default_cache()
    records = run_probes(shapes, backend=backend, platform=platform)
    cache.add_records(platform, records)
    all_records = cache.records(platform)
    coeffs = fit_coefficients(all_records, platform=platform)
    cache.set_coefficients(coeffs)
    if persist:
        cache.save()
    clear_coefficients_memo()
    return coeffs


def ingest(
    records: Sequence[Mapping[str, Any]],
    *,
    platform: Optional[str] = None,
    cache: Optional[CalibrationCache] = None,
    refit: bool = True,
    persist: bool = True,
) -> int:
    """Fold externally measured records (e.g. `launch/hillclimb.py` variant
    runs) into the calibration file; optionally refit on the union."""
    platform = platform or default_platform()
    cache = cache or default_cache()
    with _obs.span("calibrate.ingest", n=len(records), platform=platform) as sp:
        added = cache.add_records(platform, records)
        if added and refit:
            coeffs = fit_coefficients(cache.records(platform), platform=platform)
            cache.set_coefficients(coeffs)
            clear_coefficients_memo()
        # `added == 0` means nothing changed (all records invalid or empty
        # batch) — skip the save so a no-op flush never creates a cache file
        if persist and added:
            cache.save()
        sp.set("added", added)
    return added


# ---------------------------------------------------------------------------
# The planner's read path
# ---------------------------------------------------------------------------

_COEFFS_MEMO: Dict[Tuple[str, str], CostCoefficients] = {}


def current_coefficients(platform: Optional[str] = None) -> CostCoefficients:
    """Coefficients the planner should use NOW: the calibration file's fit
    for this platform when present, shipped defaults otherwise.  Memoized
    per (platform, cache path) — after `scheduler.warmup()` touches it once
    no plan-time decision performs I/O.  A broken cache degrades to
    defaults (with the cache's own quarantine warning), never raises."""
    platform = platform or default_platform()
    cache = default_cache()
    memo_key = (platform, str(cache.path))
    got = _COEFFS_MEMO.get(memo_key)
    if got is None:
        try:
            got = cache.coefficients(platform) or default_coefficients(platform)
        except Exception as e:  # pragma: no cover — load already degrades
            _rledger.record(
                "costmodel.coefficients",
                cause=f"{type(e).__name__}: {e}",
                fallback="defaults",
            )
            got = default_coefficients(platform)
        _COEFFS_MEMO[memo_key] = got
    return got


def clear_coefficients_memo() -> None:
    """Test hook: drop the per-process memo (not the persistent cache)."""
    _COEFFS_MEMO.clear()
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = None
