"""The perf hillclimb (port of `repro.launch.hillclimb`).

Three cells (worst roofline fraction / most collective-bound / most
paper-representative) and a fourth for RWKV-6, with named variants, each a
(sharding rules, parameter rules, config override, remat) tuple.  Every
variant is traced and probe-corrected by the port's dry run exactly like
the baseline sweep (`launch/dryrun.run_cell`: rank 0 of the 16 x 16
production mesh on meta tensors), so before/after numbers compare; each
writes its artifact to `artifacts/torch/hillclimb/<cell>__<variant>.json`.

A second, MEASURED lane hillclimbs the GEMM layer itself: `--gemm` times
the `GEMM_VARIANTS` through the plan/execute API (`kernels.api.plan` + the
autotuner's `measure_best_ms`, device time on the card) and writes each
measurement in the cost-model calibration record format ({"terms", "ms",
"source"}), so `costmodel.calibrate.ingest` folds them into the
coefficient fit (`--ingest` does it in the same run).  It runs on the card
unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C|D] [--variant NAME]
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --gemm [--ingest]

Where a variant's microbatch leaves a DP rank without rows (A7: 256 rows
in 64 microbatches over 16 ranks), the port's step raises, where the
reference replicates the batch; the variant prints FAILED, as the
reference's script prints any variant that does not lower.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.parallel.sharding import DEFAULT_RULES, PARAM_RULES, TRAIN_RULES

__all__ = ["CELLS", "GEMM_VARIANTS", "main", "run_gemm_variant", "run_variant"]

CELL_OUT = os.path.join("artifacts", "torch", "hillclimb")

# variant := (arch, shape, dict(rules=..., param_rules=..., cfg=..., remat=...))
_FSDP = PARAM_RULES
_SP = TRAIN_RULES  # seq_sp -> 'model' (Megatron-SP remat carriers)
_SP_ATTN = TRAIN_RULES.replace(seq_attn="model")  # + context-parallel attention

CELLS: Dict[str, Dict[str, Any]] = {
    # A: most paper-representative -- the largest dense-GEMM workload
    # (88 layers x 12288 wide); the paper's schedule is a GEMM schedule.
    "A": {
        "arch": "mistral-large-123b",
        "shape": "train_4k",
        "variants": {
            "A0_baseline": {},
            "A1_fsdp": {"param_rules": _FSDP},
            "A2_fsdp_sp": {"param_rules": _FSDP, "rules": _SP},
            "A3_fsdp_sp_flash": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024},
            },
            "A4_remat_none": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024},
                "remat": "none",
            },
            # fit pass: microbatching bounds activation residency.
            "A5_fit_ga8": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024, "grad_accum": 8},
            },
            "A6_fit_ga16": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024, "grad_accum": 16},
            },
            # ga=64 -> microbatch 4 < dp=16 (module docstring)
            "A7_fit_ga64": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024, "grad_accum": 64},
            },
            "A8_fit_rematfull_ga16": {
                "param_rules": _FSDP,
                "rules": _SP,
                "cfg": {"attn_chunk": 1024, "grad_accum": 16},
                "remat": "full",
            },
        },
    },
    # B: worst roofline fraction -- O(S^2) attention bytes at S=32k, and
    # 40 heads % 16 != 0 leaves attention unsharded on the TP axis.
    "B": {
        "arch": "phi3-medium-14b",
        "shape": "prefill_32k",
        "variants": {
            "B0_baseline": {},
            "B1_flash": {"cfg": {"attn_chunk": 1024}},
            "B2_flash_seqattn": {
                "cfg": {"attn_chunk": 1024},
                "rules": DEFAULT_RULES.replace(seq_attn="model"),
            },
            "B3_flash_seqattn_c2048": {
                "cfg": {"attn_chunk": 2048},
                "rules": DEFAULT_RULES.replace(seq_attn="model"),
            },
        },
    },
    # C: most collective-bound + the replicated-unembed pathology
    # (vocab 49155 % 16 != 0).
    "C": {
        "arch": "granite-3-8b",
        "shape": "train_4k",
        "variants": {
            "C0_baseline": {},
            "C1_vocabpad": {"cfg": {"vocab_pad_multiple": 256}},
            "C2_vocabpad_fsdp": {
                "cfg": {"vocab_pad_multiple": 256},
                "param_rules": _FSDP,
            },
            "C3_vocabpad_fsdp_sp_flash": {
                "cfg": {"vocab_pad_multiple": 256, "attn_chunk": 1024},
                "param_rules": _FSDP,
                "rules": _SP,
            },
            "C4_remat_none": {
                "cfg": {"vocab_pad_multiple": 256, "attn_chunk": 1024},
                "param_rules": _FSDP,
                "rules": _SP,
                "remat": "none",
            },
            "C5_fit_ga8": {
                "cfg": {
                    "vocab_pad_multiple": 256,
                    "attn_chunk": 1024,
                    "grad_accum": 8,
                },
                "param_rules": _FSDP,
                "rules": _SP,
            },
            "C6_fit_rematnone_ga8": {
                "cfg": {
                    "vocab_pad_multiple": 256,
                    "attn_chunk": 1024,
                    "grad_accum": 8,
                },
                "param_rules": _FSDP,
                "rules": _SP,
                "remat": "none",
            },
        },
    },
    # D: rwkv6 train -- the sequential WKV recurrence's per-step state
    # traffic dominates; the chunked GEMM-form WKV fixes it.
    "D": {
        "arch": "rwkv6-1.6b",
        "shape": "train_4k",
        "variants": {
            "D0_baseline": {},
            "D1_wkv_chunked": {"cfg": {"wkv_chunked": True}},
            "D2_wkv_chunked_sp": {"cfg": {"wkv_chunked": True}, "rules": _SP},
            "D3_fit_ga8": {
                "cfg": {"wkv_chunked": True, "grad_accum": 8},
                "rules": _SP,
            },
        },
    },
}


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


def run_variant(cell: str, name: str, out_dir: str = CELL_OUT):
    """Trace one variant of a cell through the port's dry run, write its
    artifact (with "variant") to out_dir/<cell>__<name>.json, print its
    roofline line, and return (artifact, roofline row)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import analyze_artifact

    spec = CELLS[cell]
    v = spec["variants"][name]
    art = run_cell(
        spec["arch"],
        spec["shape"],
        rules_override=v.get("rules"),
        param_rules=v.get("param_rules"),
        cfg_overrides=v.get("cfg"),
        remat=v.get("remat"),
        probe=True,
        verbose=False,
    )
    art["variant"] = name
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell}__{name}.json"), "w") as f:
        json.dump(art, f, indent=1)
    r = analyze_artifact(art)
    ma = art.get("memory_analysis", {})
    hbm_gib = (ma.get("argument_size_in_bytes", 0) + ma.get("temp_size_in_bytes", 0)) / 2**30
    print(
        f"{name:28s} compute={r['t_compute_s']:8.3f}s memory={r['t_memory_s']:8.3f}s "
        f"collective={r['t_collective_s']:8.3f}s dominant={r['dominant']:10s} "
        f"useful={r['useful_ratio']:.3f} fraction={r['roofline_fraction']:.4f} "
        f"hbm={hbm_gib:.1f}GiB"
    )
    return art, r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=sorted(CELLS))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=None,
                    help=f"default {CELL_OUT} (cells), artifacts/hillclimb (--gemm)")
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
        help="--gemm: cuda (the default; refuses to run without a CUDA device) or cpu",
    )
    args = ap.parse_args(argv)
    if not args.gemm:
        cells = [args.cell] if args.cell else sorted(CELLS)
        for cell in cells:
            spec = CELLS[cell]
            print(f"\n== cell {cell}: {spec['arch']} x {spec['shape']}")
            names = [args.variant] if args.variant else list(spec["variants"])
            for name in names:
                try:
                    run_variant(cell, name, args.out or CELL_OUT)
                except Exception as e:  # noqa: BLE001 - printed, as the reference's
                    print(f"{name:28s} FAILED: {type(e).__name__}: {e}")
        return
    device = resolve_device(args.device)
    records = []
    names = [args.variant] if args.variant else list(GEMM_VARIANTS)
    for name in names:
        try:
            records.append(run_gemm_variant(name, args.out or "artifacts/hillclimb",
                                            device=device.type))
        except Exception as e:
            print(f"{name:16s} FAILED: {type(e).__name__}: {e}")
    if args.ingest and records:
        from repro_torch.costmodel import ingest

        added = ingest(records, platform=device.type)
        print(f"ingested {added} records into the calibration file")


if __name__ == "__main__":
    main()
