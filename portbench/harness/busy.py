"""The card's busy share inside host spans: the union of the profile's
device-op intervals, clipped to the spans of one name that lie wholly
inside the profiled sub-window, over those spans' summed length.

A span counts only where the clock map of `harness.trace` (two marks 5 s
apart) holds across it.  Each `serve.prefill` and `serve.decode` holds one
`.read`, in which the host waits for a device-to-host copy, so that copy
lies inside the read.  A span whose copy (the one nearest its read) lies
more than MARGIN of the span's length outside the read is left out: the
map has drifted there.  So is a span with no read, which cannot be checked.
A kept span's device times are then off by at most MARGIN of its length
plus its read's length (0.1-0.6 ms on the card), about a point of its
share."""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from portbench.harness.trace import Profile, SpanRec, _union_within

MARGIN = 0.01
DTOH = "Memcpy DtoH"


def profiled(profile: Profile, spans: Sequence[SpanRec], name: str) -> List[SpanRec]:
    """The spans called `name` wholly inside the profiled sub-window."""
    return [s for s in spans if s.name == name and profile.t0 <= s.t0 and s.t1 <= profile.t1]


def reads_and_copies(profile: Profile,
                     reads: Sequence[SpanRec]) -> List[Tuple[SpanRec, Tuple[float, float]]]:
    """Each read paired with the device-to-host copy whose middle is nearest
    its own; reads go unpaired where the profile holds no such copy."""
    copies = [(s, e) for n, s, e in profile.ops if n.startswith(DTOH)]
    if not copies:
        return []
    starts = [s for s, _ in copies]
    out = []
    for r in reads:
        mid = (r.t0 + r.t1) / 2
        i = bisect.bisect_left(starts, mid)
        out.append((r, min(copies[max(i - 1, 0):i + 1], key=lambda c: abs((c[0] + c[1]) / 2 - mid))))
    return out


def checked(profile: Profile, spans: Sequence[SpanRec], name: str) -> Tuple[List[SpanRec], int]:
    """The profiled `name` spans whose read's copy lies within MARGIN of
    the span's length of the read, and how many profiled spans were left
    out."""
    outer = profiled(profile, spans, name)
    reads = profiled(profile, spans, name + ".read")
    pairs = reads_and_copies(profile, reads)
    kept = []
    for sp in outer:
        m = MARGIN * (sp.t1 - sp.t0)
        if any(sp.t0 <= r.t0 and r.t1 <= sp.t1 and r.t0 - m <= s and e <= r.t1 + m
               for r, (s, e) in pairs):
            kept.append(sp)
    return kept, len(outer) - len(kept)


def busy_share(run, name: str, metric: str) -> Optional[float]:
    """100 x the device-busy seconds inside the checked profiled `name`
    spans over their summed length, with a note of how many were left out;
    None off the card, with no device op, or with no such span kept."""
    p = run.profile
    if run.peaks is None or p is None or not p.ops:
        return None
    spans, left_out = checked(p, run.spans, name)
    run.note(f"[{metric}] {len(spans)} profiled {name} spans kept, {left_out} left out:"
             f" their read's device-to-host copy lies over {MARGIN:.0%} of the span outside"
             f" the read, or they have no read")
    length = sum(s.t1 - s.t0 for s in spans)
    if length <= 0:
        return None
    return 100.0 * sum(_union_within(p.ops, s.t0, s.t1) for s in spans) / length
