"""Exporters: Chrome-trace timelines, Prometheus text, and a JSONL sink.

Port of `repro.obs.export`; the three render targets for the span ring and
the metrics registry write the reference's formats:

  chrome_trace      `chrome://tracing` / Perfetto-loadable JSON: one
                    complete ("ph": "X") event per finished span, grouped
                    by thread, timestamps in microseconds relative to the
                    tracer's monotonic epoch (host times).  Run metadata
                    (calibration stamp, counters) rides in "otherData".
  prometheus_text   the text exposition format (# HELP/# TYPE + samples;
                    histograms as cumulative _bucket{le=...}/_sum/_count).
  JsonlSink         an owned, explicitly closed append-only JSONL file —
                    the sink `train.metrics.MetricsLogger` writes through.

Exports are pull-based and stay OFF the serving tick: callers flush at
drain/exit (see `launch/serve.main` and the obs bridge), never per span.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = [
    "JsonlSink",
    "chrome_trace",
    "prometheus_text",
    "write_chrome_trace",
    "write_prometheus",
    "write_spans_jsonl",
]


def _json_safe(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, Mapping):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return repr(v)


def chrome_trace(
    spans: Optional[Sequence["_trace.Span"]] = None,
    *,
    metadata: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """Render spans as a Chrome-trace document (dict; json.dump it)."""
    if spans is None:
        spans = _trace.spans()
    epoch = _trace._STATE.epoch
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "repro_torch"},
        }
    ]
    for sp in spans:
        events.append(
            {
                "ph": "X",
                "pid": pid,
                "tid": sp.tid,
                "name": sp.name,
                "cat": sp.name.split(".", 1)[0],
                "ts": (sp.t0 - epoch) * 1e6,
                "dur": max(sp.duration_s, 0.0) * 1e6,
                "args": _json_safe(dict(sp.attrs, seq=sp.seq, parent=sp.parent)),
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": _json_safe(dict(metadata or {}, spans=len(spans))),
    }


def write_chrome_trace(
    path: str,
    spans: Optional[Sequence["_trace.Span"]] = None,
    *,
    metadata: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    doc = chrome_trace(spans, metadata=metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Sequence[tuple] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    esc = lambda s: str(s).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    return "{" + ",".join(f'{n}="{esc(v)}"' for n, v in pairs) + "}"


def prometheus_text(registry: Optional["_metrics.Registry"] = None) -> str:
    """Render the registry in the Prometheus text exposition format."""
    registry = registry or _metrics.REGISTRY
    lines: List[str] = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help or m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind in ("counter", "gauge"):
            series = m.series() or ({(): 0.0} if not m.labelnames else {})
            for key, val in sorted(series.items()):
                lines.append(
                    f"{m.name}{_fmt_labels(m.labelnames, key)} {_fmt_value(val)}"
                )
        elif m.kind == "histogram":
            for key, s in sorted(m.series().items()):
                cum = 0
                for bound, c in zip(m.buckets, s["buckets"]):
                    cum += c
                    lbl = _fmt_labels(m.labelnames, key, [("le", _fmt_value(bound))])
                    lines.append(f"{m.name}_bucket{lbl} {cum}")
                cum += s["buckets"][-1]
                lbl = _fmt_labels(m.labelnames, key, [("le", "+Inf")])
                lines.append(f"{m.name}_bucket{lbl} {cum}")
                lines.append(
                    f"{m.name}_sum{_fmt_labels(m.labelnames, key)} {repr(float(s['sum']))}"
                )
                lines.append(
                    f"{m.name}_count{_fmt_labels(m.labelnames, key)} {s['count']}"
                )
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry: Optional["_metrics.Registry"] = None) -> str:
    text = prometheus_text(registry)
    with open(path, "w") as f:
        f.write(text)
    return text


class JsonlSink:
    """Append-only JSONL file with an owned, explicitly closed handle."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    @property
    def closed(self) -> bool:
        return self._fh.closed

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh.closed:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._fh.write(json.dumps(_json_safe(dict(record))) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def write_spans_jsonl(
    path: str, spans: Optional[Sequence["_trace.Span"]] = None
) -> int:
    """Dump finished spans one-per-line; returns the span count."""
    if spans is None:
        spans = _trace.spans()
    with JsonlSink(path) as sink:
        for sp in spans:
            sink.write(sp.as_dict())
    return len(spans)
