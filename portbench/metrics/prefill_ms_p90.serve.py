"""Model step, prefill (`launch/scheduler.py` `_admit`): the 90th
percentile (nearest rank) of the `serve.prefill` spans that start in the
window, each one admission from its start to its first token on the host
(the prompt's prefill, its caches' scatter into the pools, the token's
read).  Where `serve.prefill` has no `serve.prefill.read` child, it closes
before its token's read and times only the enqueue: nothing to read then.
Moves `ttft_p90_ms`."""

from portbench.harness.stats import nearest_rank


def read(run):
    if not any(s.name == "serve.prefill.read" for s in run.spans):
        return None
    lo, hi = run.window
    lengths = [s.t1 - s.t0 for s in run.spans if s.name == "serve.prefill" and lo <= s.t0 < hi]
    if not lengths:
        return None
    return nearest_rank(lengths, 0.90) * 1e3
