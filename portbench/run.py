"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` also `breakdown`, and last `checks`, each number compared with
its limit (also the last lines of standard error).  Exits non-zero with no
result where no card is present or fewer than the cell asks for, and
where a module of JAX or of the JAX package (`repro`) is loaded once the
window has closed.

The program's caches live at fixed paths inside the checkout: its kernels
build into `build/repro_torch_kernels/` (the port's own choice), and each
cell and trace mode has its own autotune and cost-model files under
`build/portbench/<cell>/trace<k>/`, so no run reads what another cell or
the other mode wrote.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path, cell: str, trace: bool) -> None:
    d = root / "build" / "portbench" / cell / f"trace{int(trace)}"
    d.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(d / "autotune_cache.json")
    os.environ["REPRO_COSTMODEL_CACHE"] = str(d / "costmodel_cache.json")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "portbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device="cuda", reduced: bool = False, t_start: float = None, **faults):
    """The result of one run (a dict; `emit` prints it).  `device`, `reduced`
    and `faults` serve the CPU tests, which skip the look for a card and
    drive the rest of a run at the port's tiny sizes."""
    import torch

    from portbench.harness import check, serve, spec, train
    from portbench.harness.trace import breakdown, device_info, power_limit

    check.reference_precision()
    cell = spec.resolve_cell(workload, root)
    cfg = spec.arch_config(cell.config, reduced=reduced)
    driver = {"serve": serve, "train": train}[cell.kind]
    got = driver.run(cell, cfg, seed=seed, seconds=seconds, trace=trace, device=device,
                     t_start=T_START if t_start is None else t_start, **faults)
    on_card = torch.device(device).type == "cuda"
    dev = (device_info(cell.chips) if on_card else
           {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    dev["memory_peak_bytes"] = got["peak_bytes"]
    names = {m["name"]: m for m in cell.end_to_end}
    result = {"correct": got["correct"], "attempted": got["attempted"], "failed": got["failed"],
              "device": dev, "checks": got["checks"], "_extra": got}
    if not trace:
        result["metrics"] = {k: {"value": v, "unit": names[k]["unit"]}
                             for k, v in got["metrics"].items() if k in names}
        return result
    record = got["record"]
    record.peaks = spec.find_peaks(dev["kind"], root) if on_card else None
    if record.peaks is not None:
        print(f"[peaks] {record.peaks['source']}: {record.peaks['bf16_flops_per_s']:.4g} FLOP/s"
              f" bf16, {record.peaks['hbm_bytes_per_s']:.4g} B/s; card: {power_limit()}",
              file=sys.stderr, flush=True)
    metrics = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], root).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    if record.profile is not None:
        dev["busy_s"] = record.profile.busy_s
        dev["window_s"] = record.profile.window_s
        result["breakdown"] = breakdown(record.profile, record.spans)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec

    cell = spec.resolve_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no run: the cell asks for {cell.chips} CUDA device(s), this machine has"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_env(ROOT, args.workload, bool(args.trace))
    torch.set_num_threads(4)  # one process, few threads: a steadier host
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result.pop("_extra")
    from portbench.harness.result import emit

    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
