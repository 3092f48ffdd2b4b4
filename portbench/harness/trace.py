"""The traced run's reduction: spans from the benchmark's own calls and the
port's `obs` spans, and `torch.profiler` over a steady sub-window.

The profiler's clock and the host's monotonic clock are tied by two marks
(`record_function`) whose host times are read beside them, so a kernel's
interval can be set against the spans open on the host at the time.  The
device is busy where any kernel, copy or set runs (the union of their
intervals); an idle gap is named by the innermost span open on the host
when it begins.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

BEGIN, END = "portbench.profile.begin", "portbench.profile.end"


@dataclasses.dataclass
class SpanRec:
    name: str
    t0: float
    t1: float
    attrs: dict


class SpanLog:
    """The finished spans the run asks for, collected as they close (the
    obs ring may drop old spans; this keeps every one named here)."""

    def __init__(self, prefixes: Sequence[str]):
        self.prefixes = tuple(prefixes)
        self.spans: List[SpanRec] = []

    def __call__(self, sp) -> None:
        if sp.name.startswith(self.prefixes):
            self.spans.append(SpanRec(sp.name, sp.t0, sp.t1, dict(sp.attrs)))


@dataclasses.dataclass
class Profile:
    """Device activity of the profiled sub-window, in host seconds."""

    t0: float
    t1: float
    ops: List[Tuple[str, float, float]]  # (name, start, end) of each device op
    busy_s: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def time_of(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the device ops whose name matches `pattern`."""
        rx = re.compile(pattern)
        hits = [(e - s) for n, s, e in self.ops if rx.search(n)]
        return sum(hits), len(hits)


class Profiler:
    """`torch.profiler` started and stopped by the run, with clock marks."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.host = {}

    @staticmethod
    def warm_up() -> None:
        """Start and stop a profiler once, in set-up, so that the profiler's
        own start-up (CUPTI's) is not paid inside the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(8).add_(1)

    def start(self) -> None:
        self._prof.__enter__()
        with torch.profiler.record_function(BEGIN):
            self.host[BEGIN] = time.monotonic()

    def stop(self) -> Profile:
        with torch.profiler.record_function(END):
            self.host[END] = time.monotonic()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        return self._reduce()

    def _reduce(self) -> Profile:
        events = self._prof.events()
        marks = {e.name: e.time_range.start for e in events if e.name in (BEGIN, END)}
        # host seconds of a profiler microsecond, by the two marks
        us0, us1 = marks[BEGIN], marks[END]
        h0, h1 = self.host[BEGIN], self.host[END]
        rate = (h1 - h0) / max(us1 - us0, 1e-9)

        def host(us):
            return h0 + (us - us0) * rate

        ops = []
        for e in events:
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                ops.append((e.name, host(e.time_range.start), host(e.time_range.end)))
        ops.sort(key=lambda x: x[1])
        busy = _union_within(ops, h0, h1)
        return Profile(t0=h0, t1=h1, ops=ops, busy_s=busy)


def _union_within(ops, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for _, s, e in ops:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:80]


def breakdown(profile: Profile, spans: Sequence[SpanRec]) -> Dict[str, list]:
    """The ten device ops that took the most time, and the ten longest idle
    gaps named by the innermost span open when each began."""
    by_op: Dict[str, float] = {}
    for n, s, e in profile.ops:
        by_op[_short(n)] = by_op.get(_short(n), 0.0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], profile.t0
    for _, s, e in profile.ops:
        if s > end and s <= profile.t1:
            gaps.append((end, s - end))
        end = max(end, e)
    if profile.t1 > end:
        gaps.append((end, profile.t1 - end))
    gaps.sort(key=lambda g: -g[1])
    named = []
    for at, length in gaps[:10]:
        open_ = [sp for sp in spans if sp.t0 <= at < sp.t1]
        inner = max(open_, key=lambda sp: sp.t0, default=None)
        named.append([inner.name if inner else "no span open", length])
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}


def device_info(chips: int) -> Dict[str, object]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
