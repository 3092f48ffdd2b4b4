"""Device, prefill: the share of the profiled `serve.prefill` spans (one
admission each, to its first token on the host) in which a kernel, copy
or set ran on the card (`harness.busy`, which leaves out the prefills
where the clock map has drifted).  Where `serve.prefill` has no
`serve.prefill.read` child it times only the enqueue, and every span is
left out: nothing to read then.  Moves `ttft_p90_ms`."""

from portbench.harness.busy import busy_share


def read(run):
    return busy_share(run, "serve.prefill", "prefill_busy.serve")
