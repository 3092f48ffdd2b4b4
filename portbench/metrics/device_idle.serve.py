"""Device, serving: the share of the profiled sub-window in which no
kernel, copy or set ran on the card.  Moves `itl_p95_ms`."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
