"""The measured GEMM lane of the perf hillclimb.

Port of `repro.launch.hillclimb --gemm`: times the `GEMM_VARIANTS` through
the plan/execute API (`kernels.api.plan` + the autotuner's
`measure_best_ms`, device time on the card) and writes each measurement in
the cost-model calibration record format ({"terms", "ms", "source"}), so
`costmodel.calibrate.ingest` folds them into the coefficient fit
(`--ingest` does it in the same run).  Runs on the card unless
`--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --gemm [--ingest]

The reference's dry-run cells (`--cell`, lowered and compiled through XLA)
arrive with the port of `launch/dryrun.py`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device

__all__ = ["GEMM_VARIANTS", "main", "run_gemm_variant"]

# GEMM-layer variants measured through plan/execute: shapes spread to
# separate the FLOP term from fixed overhead, plus the paper regimes the
# cost model prices differently (symmetric early readout, repeated products).
GEMM_VARIANTS: Dict[str, Dict[str, Any]] = {
    "G0_tiny": {"mkn": (64, 64, 64)},
    "G1_cube256": {"mkn": (256, 256, 256)},
    "G2_cube512": {"mkn": (512, 512, 512)},
    "G3_wide_n": {"mkn": (128, 256, 1024)},
    "G4_symmetric": {"mkn": (256, 256, 256), "structure": "symmetric"},
    "G5_repeats8": {"mkn": (256, 256, 256), "repeats": 8},
}


def run_gemm_variant(
    name: str,
    out_dir: str = "artifacts/hillclimb",
    *,
    backend: Optional[str] = None,
    reps: int = 3,
    device="cpu",
):
    """Time one GEMM variant through the plan/execute API on `device` and
    write the measurement as a calibration record (`costmodel.calibrate`
    format).

    `repeats=r` variants execute the plan r times back to back against the
    same operands and record the per-product mean, matching the cost
    model's amortized per-call prediction."""
    from repro_torch.costmodel import current_coefficients, predict, terms_from_describe
    from repro_torch.kernels import api
    from repro_torch.kernels.autotune import measure_best_ms

    v = GEMM_VARIANTS[name]
    m, k, n = v["mkn"]
    repeats = int(v.get("repeats", 1))
    spec = api.GemmSpec(
        m=m, k=k, n=n, structure=v.get("structure", "general"), repeats=repeats
    )
    p = api.plan(spec, backend=backend, device=device)
    a = torch.ones((m, k), dtype=torch.float32, device=device)
    b = torch.ones((k, n), dtype=torch.float32, device=device)
    if repeats > 1:

        def run_repeated(a_, b_, bias_, res_):
            out = None
            for _ in range(repeats):
                out = p.executor(a_, b_, bias_, res_)
            return out

        ms = measure_best_ms(run_repeated, a, b, None, None, reps=reps) / repeats
    else:
        ms = measure_best_ms(p.executor, a, b, None, None, reps=reps)
    terms = terms_from_describe(p.describe())
    rec = {
        "terms": terms,
        "ms": ms,
        "source": "hillclimb",
        "key": f"{name}|{p.backend}",
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"gemm__{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    pred = predict(terms, current_coefficients(p.device))["total_s"] * 1e3
    print(
        f"{name:16s} {m}x{k}x{n} backend={p.backend:12s} "
        f"measured={ms:9.3f}ms predicted={pred:9.3f}ms "
        f"ratio={ms / pred if pred else float('inf'):6.2f}x"
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None, choices=sorted(GEMM_VARIANTS))
    ap.add_argument("--out", default="artifacts/hillclimb")
    ap.add_argument(
        "--gemm", action="store_true",
        help="run the measured GEMM variants (calibration-record output)",
    )
    ap.add_argument(
        "--ingest", action="store_true",
        help="fold the GEMM measurements into the costmodel calibration file",
    )
    ap.add_argument(
        "--device", default=None,
        help="cuda (the default; refuses to run without a CUDA device) or cpu",
    )
    args = ap.parse_args(argv)
    if not args.gemm:
        ap.error("only the measured --gemm lane is ported; the dry-run cells arrive"
                 " with launch/dryrun.py")
    device = resolve_device(args.device)
    records = []
    names = [args.variant] if args.variant else list(GEMM_VARIANTS)
    for name in names:
        try:
            records.append(run_gemm_variant(name, args.out, device=device.type))
        except Exception as e:
            print(f"{name:16s} FAILED: {type(e).__name__}: {e}")
    if args.ingest and records:
        from repro_torch.costmodel import ingest

        added = ingest(records, platform=device.type)
        print(f"ingested {added} records into the calibration file")


if __name__ == "__main__":
    main()
