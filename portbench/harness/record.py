"""What a traced run hands each per-layer metric's reader.

A reader (`portbench/metrics/<metric>.py`) defines `read(run)` and
returns a number, or None where it finds nothing to read; the harness
then leaves the metric out of the line.  It never returns 0 for a share
of a roofline or a peak it could not measure.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional

from portbench.harness.trace import Profile, SpanRec


@dataclasses.dataclass
class ServedRequest:
    rid: str
    due: float  # host monotonic seconds
    prompt_len: int
    tokens: int  # served
    first_tick: Optional[int]  # tick whose end delivered the first token


@dataclasses.dataclass
class RunRecord:
    cfg: Any  # the port's ArchConfig the cell runs
    cell: Any  # harness.spec.Cell
    peaks: Optional[Dict[str, float]]  # None off the cards the table knows
    profile: Optional[Profile]
    spans: List[SpanRec]
    window: tuple  # (open, close) host monotonic seconds of the measured window
    # serving
    requests: List[ServedRequest] = dataclasses.field(default_factory=list)
    tick_end: Dict[int, float] = dataclasses.field(default_factory=dict)
    # training
    rows: int = 0
    seq_len: int = 0
    steps: int = 0
    window_s: float = 0.0
    profiled_steps: int = 0

    def note(self, text: str) -> None:
        """A line on standard error, before the result."""
        print(text, file=sys.stderr, flush=True)

    def ticks_in_profile(self) -> List[SpanRec]:
        """The `serve.tick` spans wholly inside the profiled sub-window."""
        if self.profile is None:
            return []
        return [s for s in self.spans if s.name == "serve.tick"
                and s.t0 >= self.profile.t0 and s.t1 <= self.profile.t1]

    def ops_in(self, spans: List[SpanRec], pattern: str):
        """(seconds, launches) of device ops matching `pattern` that start
        inside one of `spans` (each tick ends with a host read of its
        tokens, so its kernels end inside it)."""
        import bisect
        import re

        rx = re.compile(pattern)
        bounds = sorted((s.t0, s.t1) for s in spans)
        starts = [lo for lo, _ in bounds]
        total, count = 0.0, 0
        for name, s, e in self.profile.ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < bounds[i][1] and rx.search(name):
                total += e - s
                count += 1
        return total, count

    def within(self, spans: List[SpanRec], name: str) -> List[SpanRec]:
        """Spans called `name` that lie inside one of `spans`."""
        out = []
        for s in self.spans:
            if s.name == name and any(t.t0 <= s.t0 and s.t1 <= t.t1 for t in spans):
                out.append(s)
        return out
