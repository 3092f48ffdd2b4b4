"""Scheduler (`launch/scheduler.py`): the 90th percentile of the wait from
each request's due time to its admission, the start of its
`serve.prefill` span, over the requests due in the window.  Moves
`ttft_p90_ms`."""

from portbench.harness.stats import nearest_rank


def read(run):
    starts = {s.attrs.get("rid"): s.t0 for s in run.spans if s.name == "serve.prefill"}
    waits = [starts[r.rid] - r.due for r in run.requests if r.rid in starts]
    if not waits:
        return None
    missing = len(run.requests) - len(waits)
    run.note(f"[queue_wait_p90_ms.serve] {len(waits)} admissions of {len(run.requests)}"
             f" requests ({missing} never admitted rank as +inf)")
    return nearest_rank(waits + [float("inf")] * missing, 0.90) * 1e3
