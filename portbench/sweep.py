"""Find a serving cell's knee once, on the card: the highest offered rate
at which the backlog does not grow over the window.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 1.5,2,2.5

One process, one set-up: the server is built and warmed once, then each
rate's window runs in turn (the mix's traffic at that rate, drained before
the next).  For each rate it prints the requests due and answered, TTFT's
p50 and p90, the gaps' p95, and the queue (requests submitted and not yet
finished, beyond the slots that serve them) averaged over the window's
second and last quarters: a queue that grows from one to the other by
more than the requests due in one second means the rate is past the
knee.  Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="serve with this many slots (pages scaled to match) instead of the"
                         " configuration's")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench.run import cache_env

    cache_env(ROOT, args.workload, False)
    import torch

    from portbench.harness import check, serve, spec, traffic
    from portbench.harness.stats import nearest_rank
    from portbench.harness.weights import make_params
    from repro_torch.models import get_model

    check.reference_precision()
    cell = spec.resolve_cell(args.workload, ROOT)
    cfg = spec.arch_config(cell.config)
    if args.max_slots:
        srv = cell.config["serve"]
        srv["num_pages"] = 1 + args.max_slots * srv["max_pages_per_seq"]
        srv["max_slots"] = args.max_slots
    seeds = traffic.Seeds.of(args.seed)
    params = make_params(get_model(cfg).specs(), cfg, seeds.weights, "cuda")
    server = serve.build_server(cell, cfg, params, "cuda")
    torch.cuda.synchronize()
    ticks = 0
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, arrivals=dict(cell.mix["arrivals"], rate_per_s=rate))
        arrivals = [traffic.Arrival(f"s{k}.{a.rid}", a.due_s, a.prompt, a.max_new_tokens)
                    for a in traffic.open_loop(mix, cfg.vocab_size, seeds.traffic + k,
                                               args.seconds)]
        w = serve.drive(server, arrivals, args.seconds, first_tick=ticks)
        ticks = max(w.tick_end) if w.tick_end else ticks
        ttft, gaps, answered = [], [], 0
        for a, d in zip(arrivals, w.due):
            r = server.results.get(a.rid)
            if r is None or r.status != "ok":
                ttft.append(float("inf"))
                continue
            answered += 1
            times = serve.token_times(r, w.tick_end)
            ttft.append(times[0] - d)
            gaps += [b - c for b, c in zip(times[1:], times[:-1])]

        slots = cell.config["serve"]["max_slots"]

        def backlog(lo, hi):
            vals = [max(0, p - slots) for t, p in w.backlog
                    if lo <= (t - w.t0) / args.seconds < hi]
            return sum(vals) / len(vals) if vals else float("nan")

        row = {"rate_per_s": rate, "slots": slots, "due": len(arrivals), "answered": answered,
               "ttft_p50_ms": nearest_rank(ttft, 0.5) * 1e3,
               "ttft_p90_ms": nearest_rank(ttft, 0.9) * 1e3,
               "itl_p95_ms": nearest_rank(gaps, 0.95) * 1e3,
               "queue_q2": backlog(0.25, 0.5), "queue_q4": backlog(0.75, 1.0),
               "drain_s": w.drained - w.close}
        row["grows"] = bool(row["queue_q4"] - row["queue_q2"] > rate)
        print(json.dumps(row), flush=True)
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
