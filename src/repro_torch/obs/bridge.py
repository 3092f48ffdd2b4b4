"""Bridges between obs and the rest of the system.

Port of `repro.obs.bridge`.  Two one-way feeds, both installed by
`install()` (idempotent):

  ledger -> metrics   every `resilience.ledger.DegradationEvent` increments
                      `repro_degradations_total{site, cause}` (cause is the
                      exception-type head of the ledger's free-text cause,
                      so label cardinality stays bounded).  Installation
                      BACKFILLS events recorded before the bridge existed,
                      so the counter equals the ledger exactly.

  spans -> calibration  finished `plan.execute` spans carrying cost-model
                      `terms` become `costmodel.calibrate.ingest()` records,
                      BUFFERED.  The first span of each plan key is
                      discarded (it carries the plan's first-call costs).
                      A span of a plan run on the card carries a pair of
                      CUDA events around the execution; its record keeps
                      them, and their elapsed time becomes the record's
                      `ms` only in `flush_calibration()` — the scheduler's
                      I/O point at drain — so no serving tick waits for
                      the device.  A span with no events (the CPU) records
                      its host duration, as the reference does.  Nothing
                      touches the filesystem per span.
                      `submit_calibration()` lets benches route their own
                      measured records through the same lane.

`calibration_stamp()` reports the coefficients serving the planner right
now — exported timelines embed it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = [
    "calibration_stamp",
    "degradation_counter",
    "flush_calibration",
    "install",
    "installed",
    "pending_calibration_records",
    "submit_calibration",
    "uninstall",
]

DEGRADATION_COUNTER = "repro_degradations_total"
_MAX_PENDING = 1024  # bounded: a serve run cannot grow the buffer unbounded

_LOCK = threading.Lock()
_INSTALLED = [False]
# Records: {"terms", "ms", "source", "key"}; a record of a card execution
# holds "events" (its CUDA event pair) in place of "ms" until the flush.
_PENDING: List[Dict[str, Any]] = []
# keys whose first execution has been seen and discarded
_WARM: set = set()


def degradation_counter() -> "_metrics.Counter":
    return _metrics.counter(
        DEGRADATION_COUNTER,
        "resilience.ledger degradation events mirrored by the obs bridge",
        labels=("site", "cause"),
    )


def _cause_head(cause: str) -> str:
    """Bounded-cardinality cause label: the exception-type head."""
    return str(cause).split(":", 1)[0].strip()[:64] or "unknown"


def _mirror_event(ev) -> None:
    degradation_counter().inc(site=ev.site, cause=_cause_head(ev.cause))


def _on_span_end(sp: "_trace.Span") -> None:
    if sp.name != "plan.execute":
        return
    terms = sp.attrs.get("terms")
    if not isinstance(terms, dict):
        return
    key = sp.attrs.get("key")
    rec: Dict[str, Any] = {"terms": terms, "source": "obs", "key": key}
    if sp.events is not None:
        rec["events"] = sp.events
    else:
        rec["ms"] = sp.duration_s * 1e3
        if rec["ms"] <= 0:
            return
    with _LOCK:
        if key not in _WARM:
            _WARM.add(key)  # first execution of this plan: discard
            return
        if len(_PENDING) < _MAX_PENDING:
            _PENDING.append(rec)


def install() -> None:
    """Idempotently wire the ledger listener + span-end hook.  Events
    recorded before the bridge existed are BACKFILLED first, so the counter
    equals the ledger at the moment install returns; the listener keeps the
    two in lockstep from there."""
    from repro_torch.resilience import ledger as _ledger

    with _LOCK:
        was = _INSTALLED[0]
        _INSTALLED[0] = True
    if was:
        return
    for ev in _ledger.events():
        _mirror_event(ev)
    _ledger.add_listener(_mirror_event)
    _trace.on_span_end(_on_span_end)


def uninstall() -> None:
    """Test hook: detach both feeds and drop the pending buffer."""
    from repro_torch.resilience import ledger as _ledger

    _ledger.remove_listener(_mirror_event)
    _trace.remove_span_end(_on_span_end)
    with _LOCK:
        _INSTALLED[0] = False
        _PENDING.clear()
        _WARM.clear()


def installed() -> bool:
    return _INSTALLED[0]


def submit_calibration(records: Sequence[Mapping[str, Any]]) -> int:
    """Buffer externally measured `{"terms", "ms", ...}` records for the
    next flush (the bench lane)."""
    added = 0
    with _LOCK:
        for rec in records:
            if len(_PENDING) >= _MAX_PENDING:
                break
            _PENDING.append(dict(rec))
            added += 1
    return added


def pending_calibration_records() -> List[Dict[str, Any]]:
    """Copies of the buffered records (a card record still holds its
    "events" and no "ms": the flush reads them)."""
    with _LOCK:
        return [dict(r) for r in _PENDING]


def _resolve(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A record with its device time read from its CUDA events (waits for
    the end event), or None when that time is not positive."""
    events = rec.pop("events", None)
    if events is None:
        return rec
    rec["ms"] = _trace.events_ms(events)
    return rec if rec["ms"] > 0 else None


def flush_calibration(
    *,
    platform: Optional[str] = None,
    refit: bool = True,
    persist: bool = True,
) -> int:
    """Fold buffered records into the calibration cache (drain/exit only —
    the ONLY filesystem touch, and the only wait for the device, on the
    span->calibration lane).  Returns the number of records ingested;
    failures degrade to 0 with a ledger record, never raise into a
    shutdown path.  The platform defaults to the device the records ran on
    (`cuda` when any carries CUDA events, else `cpu`)."""
    with _LOCK:
        batch, _PENDING[:] = list(_PENDING), []
    if not batch:
        return 0
    try:
        on_card = any("events" in r for r in batch)
        batch = [r for r in map(_resolve, batch) if r is not None]
        from repro_torch.costmodel.calibrate import ingest as _ingest

        return _ingest(batch, platform=platform or ("cuda" if on_card else "cpu"),
                       refit=refit, persist=persist)
    except Exception as e:
        from repro_torch.resilience import ledger as _ledger

        _ledger.record(
            "obs.flush",
            cause=f"{type(e).__name__}: {e}",
            fallback="drop-batch",
            records=len(batch),
        )
        return 0


def calibration_stamp() -> Dict[str, Any]:
    """The coefficients the planner is using right now, for timeline
    metadata (which calibration predicted the plans this trace shows)."""
    try:
        from repro_torch.costmodel.calibrate import current_coefficients, default_cache

        co = current_coefficients()
        return {
            "platform": co.platform,
            "source": co.source,
            "flops_per_s": co.flops_per_s,
            "link_bytes_per_s": co.link_bytes_per_s,
            "phase_latency_s": co.phase_latency_s,
            "cache_path": str(default_cache().path),
        }
    except Exception:
        return {"source": "unavailable"}
