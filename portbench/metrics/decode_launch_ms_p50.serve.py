"""Host dispatch, decode (`launch/scheduler.py` `_decode`): the median
length of the `serve.decode.launch` spans that start in the window, each
the host's time to copy one decode step's inputs to the card and enqueue
the step.  Moves `itl_p95_ms`.

It is read only in a traced run, and there it includes tracing's own
cost: `plan.execute` records two CUDA events around each of a step's
GEMMs, which lengthens the enqueue by about half or more on the card.  A
change to decode dispatch reports the untraced tick beside it."""

import statistics


def read(run):
    lo, hi = run.window
    launches = [s.t1 - s.t0 for s in run.spans
                if s.name == "serve.decode.launch" and lo <= s.t0 < hi]
    if not launches:
        return None
    return statistics.median(launches) * 1e3
