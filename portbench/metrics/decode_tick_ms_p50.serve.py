"""Model step, serving (`launch/serve.py`, `models/`): the median length of
the `serve.decode` spans in the window, each one decode step of every
active slot and the host read of its tokens.  Moves `itl_p95_ms`."""

import statistics


def read(run):
    lo, hi = run.window
    ticks = [s.t1 - s.t0 for s in run.spans if s.name == "serve.decode" and lo <= s.t0 < hi]
    if not ticks:
        return None
    return statistics.median(ticks) * 1e3
