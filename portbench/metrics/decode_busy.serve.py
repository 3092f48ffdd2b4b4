"""Device, decode step: the share of the profiled `serve.decode` spans (one
decode step each, its launch and the host read of its tokens) in which a
kernel, copy or set ran on the card (`harness.busy`, which leaves out the
steps where the clock map has drifted).  Moves `itl_p95_ms`.

It also checks the clock map of `harness.trace` (two marks 5 s apart).  In
each profiled `serve.decode.read` the host copies the step's tokens to
the host and waits for the copy, so that copy starts after the span opens
and ends before it closes.  The note gives the smallest lead from the
copy's end to the span's close (negative: the map places device times
that much too late) and the largest head start of the copy before the
span opens (positive: that much too early), over every profiled read,
those of the steps left out too.  Each read is paired with the
device-to-host copy nearest to it."""

from portbench.harness.busy import busy_share, profiled, reads_and_copies


def clock_note(run) -> str:
    reads = profiled(run.profile, run.spans, "serve.decode.read")
    pairs = reads_and_copies(run.profile, reads)
    if not pairs:
        return (f"[decode_busy.serve] clock check: {len(reads)} profiled decode reads,"
                f" none paired with a device-to-host copy")
    leads = [r.t1 - e for r, (s, e) in pairs]
    heads = [r.t0 - s for r, (s, e) in pairs]
    return (f"[decode_busy.serve] clock check over {len(pairs)} profiled decode reads: smallest"
            f" lead from the copy's end to the read's close {min(leads) * 1e6:.1f} us, largest"
            f" head start of the copy before the read {max(heads) * 1e6:.1f} us")


def read(run):
    share = busy_share(run, "serve.decode", "decode_busy.serve")
    if run.peaks is not None and run.profile is not None and run.profile.ops:
        run.note(clock_note(run))
    return share
