"""The serving driver: the port's `ContinuousBatchingServer` under an open
loop of requests, on the card.

Set-up makes the weights from the seed, builds the server with the
configuration's settings, and runs its warm-up over every prompt length
the mix can produce and one decode step, so nothing builds, tunes or
compiles inside the window.  The window submits each request when it is
due and steps the server while it has work; after the window closes it
steps on until every request due in the window has its answer, at most
`DRAIN_S` seconds.  A token is delivered at the end of the `step()` call
that produced it, when the serving loop holds it: the first token comes
from the admission's prefill and the second from the same tick's decode,
then one a tick (the server's contract), so a request that finished at
tick f with n tokens had its first two at tick f - (n - 2).  TTFT runs
from the request's due time to its first token; a request that never
gets one ranks as +inf, and where a percentile lands on one the run
reports its wait until the drain ended, a lower bound.  The gaps between
tokens are those of every request due in the window.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import torch

from portbench.harness import check, traffic
from portbench.harness.record import RunRecord, ServedRequest
from portbench.harness.stats import nearest_rank
from portbench.harness.trace import Profiler, SpanLog
from portbench.harness.weights import make_params

DRAIN_S = 60.0
PROFILE_S = 5.0  # the traced run profiles the window's last PROFILE_S seconds


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """What one open-loop window saw: due times, the end of every tick
    (numbered as the server numbers them), the generator's lag."""

    def __init__(self, t0, due):
        self.t0, self.due = t0, due
        self.tick_end: Dict[int, float] = {}
        self.lags: List[float] = []
        self.close = self.drained = t0
        self.profile = None
        self.backlog: List[tuple] = []  # (time, requests submitted and not finished)


def drive(server, arrivals, seconds: float, prof=None, *, first_tick: int = 0) -> Window:
    """Submit `arrivals` when due and step `server` while it has work, for
    `seconds`; then step on until it is idle or `DRAIN_S` have passed.
    With `prof`, profile the window's last `PROFILE_S` seconds; the
    profiler's trace is read after the window closes, so reading it stalls
    only the drain."""
    from repro_torch.launch.scheduler import Request
    from repro_torch.obs import trace as obs

    p_lo = max(0.0, seconds - PROFILE_S)
    t0 = time.monotonic()
    w = Window(t0, [t0 + a.due_s for a in arrivals])
    ticks, i, n = first_tick, 0, len(arrivals)

    def step():
        nonlocal ticks
        with obs.span("portbench.step"):
            server.step()
        ticks += 1
        w.tick_end[ticks] = time.monotonic()
        w.backlog.append((w.tick_end[ticks], server.pending))

    while True:
        now = time.monotonic()
        while i < n and w.due[i] <= now:
            a = arrivals[i]
            server.submit(Request(rid=a.rid, prompt=a.prompt, max_new_tokens=a.max_new_tokens))
            w.lags.append(now - w.due[i])
            i += 1
        if prof is not None and not prof.host and now - t0 >= p_lo:
            prof.start()
        if now - t0 >= seconds and i >= n:
            break
        if server.pending:
            step()
        else:
            nxt = w.due[i] if i < n else t0 + seconds
            time.sleep(max(0.0, nxt - time.monotonic()))
    w.close = time.monotonic()
    if prof is not None and prof.host:
        w.profile = prof.stop()
    while server.pending and time.monotonic() < w.close + DRAIN_S:
        step()
    w.drained = time.monotonic()
    return w


def first_tick(result) -> int:
    """The tick that delivered a finished request's first two tokens: f - (n - 2)
    for n tokens finished at tick f (module docstring)."""
    return result.finished_tick - max(len(result.tokens) - 2, 0)


def token_times(result, tick_end: Dict[int, float]) -> List[float]:
    """When the serving loop held each token of a finished request: its
    first two at the end of its first tick, then one a tick."""
    first = first_tick(result)
    return [tick_end[first]] + [tick_end[first + max(j - 1, 0)]
                                for j in range(1, len(result.tokens))]


def build_server(cell, cfg, params, device):
    """The port's server with the configuration's settings, warmed up over
    every prompt length of the mix."""
    from repro_torch.launch.scheduler import ContinuousBatchingServer, ServeConfig
    from repro_torch.models import get_model

    srv = cell.config["serve"]
    scfg = ServeConfig(max_slots=srv["max_slots"], page_size=srv["page_size"],
                       num_pages=srv["num_pages"], max_pages_per_seq=srv["max_pages_per_seq"],
                       queue_capacity=srv["queue_capacity"],
                       default_deadline=srv["default_deadline"],
                       warmup_prompt_lens=tuple(traffic.prompt_lengths(cell.mix)))
    server = ContinuousBatchingServer(get_model(cfg), params, scfg, device=device)
    server.warmup()
    return server


def run(cell, cfg, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None) -> Dict[str, object]:
    """One run of a serving cell; the result's fields but `device`.
    `fault(server)` (tests only) may break the server before the window, as
    a faulty program would be."""
    from repro_torch.models import get_model
    from repro_torch.obs import trace as obs

    seeds = traffic.Seeds.of(seed)
    model = get_model(cfg)
    params = make_params(model.specs(), cfg, seeds.weights, device)
    server = build_server(cell, cfg, params, device)
    if fault is not None:
        fault(server)
    arrivals = traffic.open_loop(cell.mix, cfg.vocab_size, seeds.traffic, seconds)
    log = SpanLog(("serve.", "portbench."))
    if trace:
        Profiler.warm_up()
        obs.enable()
        obs.on_span_end(log)
    _sync(device)
    setup_s = time.monotonic() - t_start

    w = drive(server, arrivals, seconds, Profiler() if trace else None)
    if trace:
        obs.disable()
        obs.remove_span_end(log)
    due, tick_end = w.due, w.tick_end

    requests: List[ServedRequest] = []
    ttft: List[float] = []
    gaps: List[float] = []
    done = []
    unanswered = 0
    for a, d in zip(arrivals, due):
        r = server.results.get(a.rid)
        if r is None or r.status != "ok" or len(r.tokens) != a.max_new_tokens:
            unanswered += 1
            ttft.append(float("inf"))
            requests.append(ServedRequest(a.rid, d, len(a.prompt), 0, None))
            continue
        times = token_times(r, tick_end)
        ttft.append(times[0] - d)
        gaps += [b - c for b, c in zip(times[1:], times[:-1])]
        requests.append(ServedRequest(a.rid, d, len(a.prompt), len(r.tokens), first_tick(r)))
        done.append((a.prompt, list(r.tokens)))
    p90 = nearest_rank(ttft, 0.90)
    if p90 == float("inf"):
        p90 = max(w.drained - d for d, t in zip(due, ttft) if t == float("inf"))
    n = len(arrivals)
    print(f"[serve] {n} requests due in {seconds} s; {n - unanswered} answered, {unanswered}"
          f" not; {len(tick_end)} ticks; generator lag max {max(w.lags) * 1e3:.3f} ms, p99"
          f" {nearest_rank(w.lags, 0.99) * 1e3:.3f} ms; drain {w.drained - w.close:.2f} s",
          file=sys.stderr, flush=True)
    metrics = {"ttft_p90_ms": p90 * 1e3, "itl_p95_ms": nearest_rank(gaps, 0.95) * 1e3,
               "setup_s": setup_s}
    record = RunRecord(cfg=cfg, cell=cell, peaks=None, profile=w.profile, spans=log.spans,
                       window=(w.t0, w.close), requests=requests, tick_end=tick_end)
    peak_bytes = (int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda"
                  else 0)

    # The check: the program's state freed, the weights drawn again.
    del server, params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    picked = check.sample_requests(done, seeds.sample, cell.config["correct"]["sample_tokens"])
    samples = [done[j] for j in picked]
    params = make_params(model.specs(), cfg, seeds.weights, device)
    gap, compared = check.served_token_gap(params, cfg, samples)
    limit = cell.config["correct"]["served_token_gap"]
    print(f"[serve] compared {compared} served tokens of {len(samples)} requests against the"
          f" float32 reference", file=sys.stderr, flush=True)
    checks = {"served_token_gap": {"value": gap, "limit": limit},
              "unanswered": {"value": unanswered, "limit": 0}}
    correct = bool(compared > 0 and gap <= limit and unanswered == 0)
    return {"correct": correct, "attempted": len(arrivals), "failed": unanswered, "metrics": metrics,
            "record": record, "checks": checks, "peak_bytes": peak_bytes,
            "params": params, "samples": samples}
