"""Observability: spans, metrics, exports, and the bridge to calibration.

Port of `repro.obs`.  Quickstart::

    from repro_torch import obs

    obs.enable()                      # tracing is OFF by default
    with obs.span("plan.execute", backend="torch"):
        ...
    obs.counter("served_total").inc()
    print(obs.prometheus_text())
    obs.write_chrome_trace("trace.json")   # load in chrome://tracing

Span names follow the `layer.verb` convention (plan.build, plan.execute,
autotune.measure, serve.tick, serve.decode, calibrate.ingest, ...).  The
scheduler's tick nests serve.prefill (serve.prefill.launch,
serve.prefill.scatter, serve.prefill.read), serve.decode
(serve.decode.launch, serve.decode.read) and serve.retire;
`launch/scheduler.py` says what each one covers.
"""

from repro_torch.obs.bridge import (
    calibration_stamp,
    flush_calibration,
    install,
    pending_calibration_records,
    submit_calibration,
    uninstall,
)
from repro_torch.obs.export import (
    JsonlSink,
    chrome_trace,
    prometheus_text,
    write_chrome_trace,
    write_prometheus,
    write_spans_jsonl,
)
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    histogram,
    snapshot,
)
from repro_torch.obs.trace import (
    Span,
    configure,
    disable,
    enable,
    is_enabled,
    on_span_end,
    remove_span_end,
    span,
    spans,
    stats,
    traced,
    tracing,
)
from repro_torch.obs.trace import clear as clear_spans
from repro_torch.obs.metrics import reset as reset_metrics

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "LATENCY_BUCKETS_S",
    "REGISTRY",
    "Registry",
    "Span",
    "calibration_stamp",
    "chrome_trace",
    "clear_spans",
    "configure",
    "counter",
    "disable",
    "enable",
    "flush_calibration",
    "gauge",
    "histogram",
    "install",
    "is_enabled",
    "on_span_end",
    "pending_calibration_records",
    "prometheus_text",
    "remove_span_end",
    "reset_metrics",
    "snapshot",
    "span",
    "spans",
    "stats",
    "submit_calibration",
    "traced",
    "tracing",
    "uninstall",
    "write_chrome_trace",
    "write_prometheus",
    "write_spans_jsonl",
]
