"""Process-wide degradation ledger (port of `repro.resilience.ledger`).

Every graceful-degradation decision — a shed request, a skipped scheduler
tick, a deferred page allocation, a preempted sequence — records one
`DegradationEvent` here.  The ledger is the operator's view of how much of
the process is running degraded: `serve` prints `format_summary()` at exit
and fault-injection tests assert on it.

Events are timestamp-free by design (a monotonic `seq` orders them): the
ledger must be byte-stable across runs so CI can diff it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DegradationEvent",
    "add_listener",
    "clear",
    "count",
    "events",
    "format_summary",
    "record",
    "remove_listener",
    "summary",
]


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One degradation decision: what failed, why, and what absorbed it.

    seq       process-wide monotonic counter (timestamp-free ordering)
    site      the fault site (same names as `resilience.faults`)
    cause     human-readable failure description ("FaultError: ...")
    fallback  what the process degraded TO ("xla", "replicated", "retry#1",
              "zero", "quarantine", ...)
    detail    sorted (key, value-repr) pairs of extra context
    """

    seq: int
    site: str
    cause: str
    fallback: str
    detail: Tuple[Tuple[str, str], ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "site": self.site,
            "cause": self.cause,
            "fallback": self.fallback,
            "detail": dict(self.detail),
        }


_EVENTS: List[DegradationEvent] = []
_SEQ = [0]
_LOCK = threading.Lock()
_LISTENERS: List[Any] = []


def add_listener(fn) -> None:
    """Subscribe `fn(event)` to every future `record()` (the obs bridge
    mirrors events into metrics through this).  Listeners run OUTSIDE the
    ledger lock; a raising listener is ignored, never the recorder's
    problem."""
    with _LOCK:
        if fn not in _LISTENERS:
            _LISTENERS.append(fn)


def remove_listener(fn) -> None:
    with _LOCK:
        if fn in _LISTENERS:
            _LISTENERS.remove(fn)


def record(site: str, cause: str, fallback: str, **detail: Any) -> DegradationEvent:
    """Append one event (thread-safe; the checkpoint worker records too)."""
    with _LOCK:
        _SEQ[0] += 1
        ev = DegradationEvent(
            seq=_SEQ[0],
            site=str(site),
            cause=str(cause),
            fallback=str(fallback),
            detail=tuple(sorted((str(k), repr(v)) for k, v in detail.items())),
        )
        _EVENTS.append(ev)
        listeners = list(_LISTENERS)
    for fn in listeners:
        try:
            fn(ev)
        except Exception:
            pass
    return ev


def events(site: Optional[str] = None) -> List[DegradationEvent]:
    with _LOCK:
        evs = list(_EVENTS)
    return evs if site is None else [e for e in evs if e.site == site]


def count(site: Optional[str] = None) -> int:
    return len(events(site))


def summary() -> Dict[str, Dict[str, int]]:
    """{site: {fallback: count}} — the shape `serve --plan-stats` prints."""
    out: Dict[str, Dict[str, int]] = {}
    for e in events():
        out.setdefault(e.site, {})
        out[e.site][e.fallback] = out[e.site].get(e.fallback, 0) + 1
    return out


def format_summary(prefix: str = "[resilience]") -> str:
    """Multi-line printable summary; one line when the ledger is empty."""
    evs = events()
    if not evs:
        return f"{prefix} ledger: no degradation events (all paths healthy)"
    lines = [f"{prefix} ledger: {len(evs)} degradation event(s)"]
    for site, falls in sorted(summary().items()):
        per = ", ".join(f"{fb} x{c}" for fb, c in sorted(falls.items()))
        lines.append(f"{prefix}   {site:22s} -> {per}")
    tail = evs[-5:]
    for e in tail:
        lines.append(
            f"{prefix}   #{e.seq} {e.site}: {e.cause[:80]} -> {e.fallback}"
        )
    return "\n".join(lines)


def clear() -> None:
    """Test hook: drop all events and reset the sequence counter."""
    with _LOCK:
        _EVENTS.clear()
        _SEQ[0] = 0
