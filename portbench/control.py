"""The readings the limits of `correct` are set from, on the card at a
cell's own size: the control (the reference at float8, in the program's
place) and, for training, the half-batch fault.  Not part of a benchmark
run; `PERF.md` keeps its output beside each limit.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]

Serving: for each seed the program serves the cell's traffic for
`--seconds` (the drain finishes the longest requests), the sample a run
would compare is drawn, and both readings are printed: the program's
widest served-token gap, and the control's (at each of the same
positions, the gap of the token the float8 reference puts first).

Training: for each seed the float32 reference's three steps against the
float8 reference's (the control) and against the reference's on the
first half of each batch's rows (the half-batch fault); a state left
unchanged reads 1 on both leaf norms and needs no run.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench.run import cache_env

    cache_env(ROOT, args.workload, False)
    import torch

    from portbench.harness import check, serve, spec, train, traffic

    check.reference_precision()
    cell = spec.resolve_cell(args.workload, ROOT)
    cfg = spec.arch_config(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        seeds = traffic.Seeds.of(seed)
        if cell.kind == "serve":
            got = serve.run(cell, cfg, seed=seed, seconds=args.seconds, trace=False,
                            device="cuda", t_start=t0)
            control, n = check.served_token_gap(got["params"], cfg, got["samples"], control=True)
            row = {"seed": seed, "program": got["checks"]["served_token_gap"]["value"],
                   "control": control, "tokens": n, "answered": got["attempted"] - got["failed"]}
            del got
        else:
            refr = train.reference_readings(cell, cfg, seeds, "cuda")
            fp8 = train.reference_readings(cell, cfg, seeds, "cuda", fp8=True)
            half = train.reference_readings(cell, cfg, seeds, "cuda",
                                            rows=cell.config["train"]["rows"] // 2)
            row = {"seed": seed, "control": check.train_numbers(fp8, refr),
                   "half_batch": check.train_numbers(half, refr),
                   "losses": {"f32": refr["losses"], "fp8": fp8["losses"], "half": half["losses"]}}
            del refr, fp8, half
        gc.collect()
        torch.cuda.empty_cache()
        row["seconds"] = time.monotonic() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
