"""Structured tracing: nestable spans over a process-wide ring buffer.

Port of `repro.obs.trace`.  Spans are named, nestable intervals with
monotonic host times and JSON-able attributes, cheap enough to leave in
the hot paths permanently.

Design contract:

  off by default   tracing is a hard opt-in (`enable()` / the `tracing()`
                   scope).  The DISABLED fast path of `span()` is a single
                   attribute check (`_STATE.enabled`) returning a shared
                   no-op span.
  nestable         spans nest via a per-thread stack: `parent` links child
                   spans to the enclosing one, so exports reconstruct a
                   request's life (serve.tick -> serve.decode -> ...).
  bounded          finished spans land in one process-wide ring
                   (deque(maxlen)); old spans are dropped, never grown
                   without bound — `stats()["dropped"]` counts the loss.
  thread-safe      the ring, the seq counter, and the end hooks are guarded
                   by one lock; span stacks are thread-local.
  trace-aware      a span must never fire while PyTorch traces instead of
                   running: under `torch.compile` (dynamo) or a CUDA-graph
                   capture the host clock would measure the trace, once,
                   not each execution.  Such spans are suppressed and
                   counted in `stats()["suppressed_in_trace"]`.
  device time      a span's times are host times.  A caller that enqueues
                   work on the card may attach a pair of CUDA events
                   (`Span.events`); they are read only when somebody asks
                   (`device_ms()`, which waits for the end event), never
                   while the span closes.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = [
    "Span",
    "clear",
    "configure",
    "disable",
    "enable",
    "events_ms",
    "is_enabled",
    "on_span_end",
    "remove_span_end",
    "span",
    "spans",
    "stats",
    "traced",
    "tracing",
]

DEFAULT_CAPACITY = 65536


class _State:
    """Process-wide tracer state; `enabled` is THE disabled-path check."""

    __slots__ = ("enabled", "capacity", "epoch")

    def __init__(self) -> None:
        self.enabled = False
        self.capacity = DEFAULT_CAPACITY
        # monotonic origin all span times are relative to in exports
        self.epoch = time.monotonic()


_STATE = _State()
_LOCK = threading.Lock()
_RING: "collections.deque" = collections.deque(maxlen=DEFAULT_CAPACITY)
_HOOKS: List[Callable[["Span"], None]] = []
_LOCAL = threading.local()
_SEQ = [0]
_STATS = {"started": 0, "finished": 0, "dropped": 0, "suppressed_in_trace": 0}


def _in_trace() -> bool:
    """True while PyTorch traces rather than runs: dynamo compiling, or the
    current CUDA stream capturing a graph (asked only once CUDA is up)."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class Span:
    """One finished-or-open interval.  Mutable while open (`set()` adds
    attributes mid-span); append-only once it lands in the ring.  `events`
    is None or a (start, end) pair of timing CUDA events around the span's
    device work."""

    __slots__ = ("name", "seq", "parent", "tid", "t0", "t1", "attrs", "events")

    def __init__(self, name: str, seq: int, parent: Optional[int], tid: int,
                 t0: float, attrs: Dict[str, Any]):
        self.name = name
        self.seq = seq
        self.parent = parent
        self.tid = tid
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs
        self.events = None

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, key: str, value: Any) -> None:
        """Attach an attribute discovered mid-span (e.g. a chosen schedule)."""
        self.attrs[key] = value

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events, or None without
        them.  Waits for the end event: call it where a wait is allowed."""
        return None if self.events is None else events_ms(self.events)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seq": self.seq,
            "parent": self.parent,
            "tid": self.tid,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, seq={self.seq}, parent={self.parent},"
            f" dur={self.duration_s * 1e3:.3f}ms)"
        )

    # -- context-manager protocol -------------------------------------------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _end_span(self, exc)
        return False


def events_ms(events) -> float:
    """Milliseconds between a (start, end) pair of timing CUDA events; waits
    for the end event."""
    start, end = events
    end.synchronize()
    return start.elapsed_time(end)


class _NullSpan:
    """The disabled/suppressed path: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


_NULL = _NullSpan()


def _stack() -> List[Span]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def span(name: str, **attrs: Any):
    """Open a span; use as ``with span("plan.execute", backend="torch"): ...``.

    Disabled tracing returns a shared no-op span after ONE attribute check.
    Enabled tracing inside a trace or capture is suppressed.
    """
    if not _STATE.enabled:
        return _NULL
    return _begin(name, attrs)


def _begin(name: str, attrs: Dict[str, Any]):
    if _in_trace():
        with _LOCK:
            _STATS["suppressed_in_trace"] += 1
        return _NULL
    st = _stack()
    parent = st[-1].seq if st else None
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
        _STATS["started"] += 1
    sp = Span(name, seq, parent, threading.get_ident(), time.monotonic(), attrs)
    st.append(sp)
    return sp


def _end_span(sp: Span, exc: Optional[BaseException]) -> None:
    sp.t1 = time.monotonic()
    if exc is not None:
        sp.attrs["error"] = f"{type(exc).__name__}: {exc}"
    st = _stack()
    # Tolerate out-of-order exits (a span leaked across a raise): pop up to
    # and including this span if present, else leave the stack alone.
    if sp in st:
        while st and st.pop() is not sp:
            pass
    with _LOCK:
        _STATS["finished"] += 1
        if _RING.maxlen is not None and len(_RING) == _RING.maxlen:
            _STATS["dropped"] += 1
        _RING.append(sp)
        hooks = list(_HOOKS)
    for fn in hooks:
        try:
            fn(sp)
        except Exception:
            pass  # a broken hook must never take the traced path down


def traced(name_or_fn=None, **attrs: Any):
    """Decorator form: ``@traced`` or ``@traced("layer.verb", key=...)``."""

    def deco(fn: Callable, name: Optional[str] = None) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _STATE.enabled:
                return fn(*args, **kwargs)
            with _begin(label, dict(attrs)):
                return fn(*args, **kwargs)

        return wrapper

    if callable(name_or_fn):
        return deco(name_or_fn)
    return lambda fn: deco(fn, name_or_fn)


# ---------------------------------------------------------------------------
# Switches + introspection
# ---------------------------------------------------------------------------


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (optionally resizing the ring)."""
    if capacity is not None:
        configure(capacity=capacity)
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def is_enabled() -> bool:
    return _STATE.enabled


class tracing:
    """Scoped enable: ``with tracing(): ...`` restores the prior state."""

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity
        self._prior = False

    def __enter__(self) -> "tracing":
        self._prior = _STATE.enabled
        enable(self._capacity)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _STATE.enabled = self._prior
        return False


def configure(*, capacity: int) -> None:
    """Resize the ring (keeps the newest spans that still fit)."""
    global _RING
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    with _LOCK:
        _STATE.capacity = capacity
        _RING = collections.deque(_RING, maxlen=capacity)


def spans(name: Optional[str] = None) -> List[Span]:
    """Snapshot of finished spans, oldest first (optionally filtered)."""
    with _LOCK:
        got = list(_RING)
    return got if name is None else [s for s in got if s.name == name]


def stats() -> Dict[str, int]:
    with _LOCK:
        d = dict(_STATS)
        d["retained"] = len(_RING)
        d["capacity"] = _STATE.capacity
    return d


def clear() -> None:
    """Test hook: drop finished spans and reset counters (keeps `enabled`)."""
    with _LOCK:
        _RING.clear()
        _SEQ[0] = 0
        for k in _STATS:
            _STATS[k] = 0


def on_span_end(fn: Callable[[Span], None]) -> None:
    """Register a finished-span hook (the obs bridge feeds calibration
    through this).  Hooks run outside the lock; exceptions are swallowed."""
    with _LOCK:
        if fn not in _HOOKS:
            _HOOKS.append(fn)


def remove_span_end(fn: Callable[[Span], None]) -> None:
    with _LOCK:
        if fn in _HOOKS:
            _HOOKS.remove(fn)
