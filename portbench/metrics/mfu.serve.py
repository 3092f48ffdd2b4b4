"""Whole serving step: the operations the window's prefills and decode
tokens need (`harness.work`: every layer's products at each prompt
position, attention over the causal keys, the head at the last prompt
position and at each decode token) over the summed `serve.tick` spans of
the window that ran them, times the card's bf16 peak.  Moves
`ttft_p90_ms`."""

from portbench.harness import work


def read(run):
    if run.peaks is None:
        return None
    lo, hi = run.window
    ticks = {s.attrs["tick"]: s.t1 - s.t0 for s in run.spans
             if s.name == "serve.tick" and lo <= s.t0 and s.t1 <= hi}
    flops, busy = 0, set()
    for r in run.requests:
        if r.first_tick is None:
            continue
        if r.first_tick in ticks:
            flops += work.prefill_flops(run.cfg, r.prompt_len)
            busy.add(r.first_tick)
        for j in range(1, r.tokens):
            tick = r.first_tick + j - 1
            if tick in ticks:
                flops += work.decode_flops(run.cfg, r.prompt_len + j)
                busy.add(tick)
    seconds = sum(ticks[t] for t in busy)
    if not seconds:
        return None
    return 100.0 * flops / (seconds * run.peaks["bf16_flops_per_s"])
