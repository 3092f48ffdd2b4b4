"""Minimal structured metrics logging: stdout plus an optional JSONL file
(port of `repro.train.metrics`, with its own small sink in place of
`repro.obs.export.JsonlSink`)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Mapping, Optional

__all__ = ["JsonlSink", "MetricsLogger"]


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, Mapping):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return repr(v)


class JsonlSink:
    """Append-only JSONL file with an owned, explicitly closed handle."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh.closed:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._fh.write(json.dumps(_json_safe(dict(record))) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream=None):
        self.stream = stream or sys.stdout
        self._sink = JsonlSink(path) if path else None
        self.history: list = []

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "t": time.time(), **metrics}
        self.history.append(rec)
        short = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        )
        print(f"[step {step}] {short}", file=self.stream)
        if self._sink:
            self._sink.write(rec)

    def warn(self, msg: str) -> None:
        print(f"[warn] {msg}", file=self.stream)

    def summary(self, info: Dict[str, Any]) -> None:
        print(f"[summary] {json.dumps(info)}", file=self.stream)
        if self._sink:
            self._sink.write({"summary": info})

    def close(self) -> None:
        if self._sink:
            self._sink.close()
