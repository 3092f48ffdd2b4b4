"""Minimal structured metrics logging (stdout + optional JSONL file).

Port of `repro.train.metrics`.  The optional file lane writes through
`repro_torch.obs.export.JsonlSink`, which owns the handle: `close()` (or
using the logger as a context manager) releases it deterministically.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

from repro_torch.obs.export import JsonlSink

__all__ = ["JsonlSink", "MetricsLogger"]


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream=None):
        self.path = path
        self.stream = stream or sys.stdout
        self._sink = JsonlSink(path) if path else None
        self.history: list = []

    @property
    def closed(self) -> bool:
        return self._sink.closed if self._sink else False

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

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
