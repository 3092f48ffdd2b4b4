"""Analytical GEMM cost model.

Port of `repro.costmodel.model`.  The planner predicts the wall time of
one plan execution from the same terms `launch/roofline.analyze_plan`
reports — compute, memory and collective seconds — parameterized by
per-platform `CostCoefficients`.  Everything here is pure arithmetic over
`Plan.describe()`-shaped records: no torch, no timing, no I/O —
`costmodel/calibrate.py` owns measurement and persistence, and
`costmodel/choose.py` owns candidate enumeration.

Two ingredients go beyond a plain roofline, both from the paper family:

  * structure_step_factor — a `structure="symmetric"` product reads out in
    `symmetric_readout_steps(n)` ≈ floor(3n/2) mesh steps instead of the
    general 2n-1 (Kak 2010 §symmetries), so its compute term scales by that
    ratio; general and scrambled products pay the full 2n-1 horizon.
  * repeat_amortization — `GemmSpec.repeats` declares that the plan runs r
    times back to back against resident weights.  The cross-wired mesh
    array computes r pipelined products in r·n + (n-1) steps (Kak,
    arXiv:1411.3273), so the per-product step cost falls from 2n-1 toward
    n; the B operand also streams once, not r times.

`predict` combines the terms as `max(compute, memory) + collective +
latency` for serial schedules, and `max(compute, memory, collective) +
latency` for terms marked `overlap` (double-buffered rings).

Platforms are device types: `cpu` keeps the reference's CPU coefficients
(backend names mapped: `xla` -> `torch`, `pallas_mesh` -> `cuda_mesh`), so
CPU decisions equal the reference's; `cuda` holds data-sheet numbers for
one NVIDIA H100 SXM, uncalibrated (`source="default"`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

__all__ = [
    "COST_MODEL_VERSION",
    "CostCoefficients",
    "default_coefficients",
    "predict",
    "predict_blocks_ms",
    "repeat_amortization",
    "structure_step_factor",
    "terms_from_describe",
]

COST_MODEL_VERSION = 1

# Largest n whose symmetric readout horizon is computed exactly from the
# mesh completion times (O(n^2) work, cached); beyond it the empirical
# closed form floor(3n/2) is used (validated against exact in tests).
_EXACT_SYMMETRIC_N = 128

# Bytes per element of the dtype names describe() records carry.
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """Per-platform hardware coefficients the prediction is linear in.

    `backend_efficiency` maps backend names to the fraction of
    `flops_per_s` that backend sustains (1.0 = the platform's best GEMM
    path); unknown backends get `default_efficiency`.  `source` records
    whether the numbers are shipped defaults or a measured calibration
    (see calibrate.py); frozen + tuple-typed so coefficients are hashable
    and usable in memo keys.
    """

    flops_per_s: float
    hbm_bytes_per_s: float
    link_bytes_per_s: float
    phase_latency_s: float = 0.0
    launch_overhead_s: float = 0.0
    backend_efficiency: Tuple[Tuple[str, float], ...] = ()
    default_efficiency: float = 0.5
    platform: str = "cpu"
    source: str = "default"

    def efficiency(self, backend: Optional[str]) -> float:
        for name, eff in self.backend_efficiency:
            if name == backend:
                return eff
        return self.default_efficiency

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["backend_efficiency"] = {k: v for k, v in self.backend_efficiency}
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CostCoefficients":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        be = kw.get("backend_efficiency") or ()
        if isinstance(be, Mapping):
            be = tuple(sorted((str(k), float(v)) for k, v in be.items()))
        else:
            be = tuple((str(k), float(v)) for k, v in be)
        kw["backend_efficiency"] = be
        return cls(**kw)


# One NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet: dense bf16
# on the tensor cores, HBM3, and NVLink 4 at 900 GB/s both ways, 450 GB/s
# each way between two cards.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9


def default_coefficients(platform: Optional[str] = None) -> CostCoefficients:
    """Shipped coefficients.  `cpu` (the default): the reference's CPU
    numbers, anchored to its measured CPU XLA GEMM series.  `cuda`: the
    H100 data-sheet rates above, uncalibrated; the per-backend efficiencies
    are relative to the bf16 tensor-core rate.  `torch` (cuBLAS) is the
    platform's best GEMM path, 1.0.  `cuda_mesh` is what kernel K1 reaches
    against `torch.matmul` at mesh-paper's training shapes: 2.6-2.8x its
    device time in bf16 (PERF.md §6, measured by chip_smoke.py on an
    NVIDIA H100 80GB HBM3 at a 700 W power limit), so 1/2.8.  `ref` runs
    an f32 matmul of upcast operands: 67 of 989 TFLOP/s on the data sheet.
    So the shipped order on the card is torch, then cuda_mesh.  Latency
    coefficients default to zero; calibration fits them."""
    if platform == "cuda":
        return CostCoefficients(
            flops_per_s=H100_BF16_FLOPS,
            hbm_bytes_per_s=H100_HBM_BYTES_PER_S,
            link_bytes_per_s=H100_NVLINK_BYTES_PER_S,
            backend_efficiency=(("cuda_mesh", 1 / 2.8), ("ref", 67 / 989), ("torch", 1.0)),
            platform="cuda",
        )
    return CostCoefficients(
        flops_per_s=1e11,
        hbm_bytes_per_s=2e10,
        link_bytes_per_s=1e10,
        # the mesh kernel's plain version runs block by block; ref
        # materializes upcast operands — both far off the library GEMM
        backend_efficiency=(("cuda_mesh", 0.05), ("ref", 0.01), ("torch", 1.0)),
        platform=str(platform or "cpu"),
    )


@functools.lru_cache(maxsize=None)
def _symmetric_steps(n: int) -> int:
    if n <= _EXACT_SYMMETRIC_N:
        from repro_torch.core.symmetries import symmetric_readout_steps

        return symmetric_readout_steps(n)
    return (3 * n) // 2  # empirical closed form (== exact for all tested n)


def structure_step_factor(structure: str, n: int) -> float:
    """Per-product step-count ratio vs the general 2n-1 readout horizon.

    symmetric products finish at `symmetric_readout_steps(n)` (the paper's
    n+1+n/2 bound, empirically floor(3n/2)); general and scrambled pay the
    full horizon (the σ arrangement permutes cells, it doesn't finish
    earlier), factor 1.0.
    """
    n = max(1, int(n))
    if structure != "symmetric" or n == 1:
        return 1.0
    return _symmetric_steps(n) / (2 * n - 1)


def repeat_amortization(repeats: int, n: int) -> float:
    """Per-product step factor for r pipelined products on the cross-wired
    array: r products take r·n + (n-1) steps, so each costs
    (n + (n-1)/r) / (2n-1) of a standalone product — 1.0 at r=1, falling
    toward n/(2n-1) ≈ 1/2 as the pipeline fills."""
    r = max(1, int(repeats))
    n = max(1, int(n))
    return (n + (n - 1) / r) / (2 * n - 1)


def terms_from_describe(desc: Mapping[str, Any]) -> Dict[str, Any]:
    """Machine-usable cost terms for one `Plan.describe()` record.

    This is the single owner of the byte/FLOP arithmetic `roofline
    .analyze_plan` reports (the reference's conventions: ring
    schedules stream `kernel_invocations` A chunks and output tiles per
    call, batched_b scales per-element traffic by the batch, grouped specs
    stream every group's weight slab plus the dispatch routing bytes, with
    EP scaling both to the per-device share).  Unknown record shapes
    degrade to the plain-GEMM arithmetic instead of raising.
    """
    sh = desc.get("sharding") or {}
    grp = desc.get("grouped") or {}
    flops = sh.get("per_shard_flops", desc["flops"])
    if "per_shard_mkn" in sh:
        m, k, n = (int(x) for x in sh["per_shard_mkn"])
        # batched_b local specs keep their batch dims out of eff_m
        nb = math.prod(sh.get("per_shard_batch") or [1])
    else:
        m, k, n = (int(x) for x in desc["mkn"].split("x"))
        # "mkn" folds batch into M only for 2D b; batched_b products stream
        # per-element A/B/C, so scale bytes to match the batch-inclusive FLOPs
        nb = math.prod(desc.get("batch") or [1]) if desc.get("batched_b") else 1
    dt_a, dt_b = desc.get("dtypes", ["float32", "float32"])
    ia = ITEMSIZE[dt_a]
    ib = ITEMSIZE[dt_b]
    io = ITEMSIZE[desc.get("out_dtype") or "float32"]
    # Ring schedules re-invoke the per-shard kernel once per step: the device
    # streams `inv` A chunks and writes `inv` output tiles per call.
    inv = int(sh.get("kernel_invocations", 1))
    dispatch_bytes = 0
    if grp:
        # Grouped: M is the total row bound (rows stream once), but the
        # weight term is per GROUP — every (K, N) slab streams — and the
        # sort/scatter/gather routing traffic rides the memory term too.
        n_groups = grp.get("num_groups", 1)
        dispatch_bytes = grp.get("dispatch_bytes", 0)
        if sh:
            # expert schedule: `m` above is already the per-shard row count
            # (per_shard_mkn); scale group count and dispatch traffic to the
            # per-device share using the group axis size from the record
            mesh_sizes = {nm: s for nm, s in sh.get("mesh", [])}
            pg = mesh_sizes.get((sh.get("axes") or {}).get("g"), 1) or 1
            n_groups = max(1, n_groups // pg)
            dispatch_bytes //= pg
        a_bytes = m * k * ia
        b_bytes = n_groups * k * n * ib
        out_bytes = m * n * io
    else:
        a_bytes = nb * inv * m * k * ia
        b_bytes = nb * k * n * ib
        out_bytes = nb * inv * m * n * io
    return {
        "flops": int(flops),
        "a_bytes": int(a_bytes),
        "b_bytes": int(b_bytes),
        "out_bytes": int(out_bytes),
        "dispatch_bytes": int(dispatch_bytes),
        "hbm_bytes": int(a_bytes + b_bytes + out_bytes + dispatch_bytes),
        "collective_bytes": int(sh.get("bytes_moved", 0)),
        "collective_phases": int(sh.get("collective_phases", 0)),
        "kernel_invocations": inv,
        "overlap": bool(sh.get("overlap", False)),
        "schedule": sh.get("schedule"),
        "structure": desc.get("structure", "general"),
        "readout_n": n,
        "repeats": int(desc.get("repeats", 1)),
        "backend": desc.get("backend"),
    }


def predict(
    terms: Mapping[str, Any],
    coeffs: CostCoefficients,
    *,
    backend: Optional[str] = None,
) -> Dict[str, float]:
    """Predicted seconds for one execution of a plan with these terms.

    total = max(compute, memory) + collective + latency — compute overlaps
    HBM streaming, a serial collective is a barrier, and latency charges
    the per-phase and per-launch fixed costs.  Terms with `overlap` set
    (the double-buffered ring schedules) hide the collective behind the
    kernel calls instead: total = max(compute, memory, collective) +
    latency.  The paper-structure factors scale the compute term
    (symmetric early readout) and amortize launch latency and B streaming
    over `repeats` pipelined products.
    """
    be = backend if backend is not None else terms.get("backend")
    eff = max(coeffs.efficiency(be), 1e-6)
    n = int(terms.get("readout_n", 1))
    r = max(1, int(terms.get("repeats", 1)))
    factor = structure_step_factor(terms.get("structure", "general"), n)
    amort = repeat_amortization(r, n)
    t_compute = terms["flops"] / (coeffs.flops_per_s * eff) * factor * amort
    # With repeats the weights stay resident: B streams once per r products.
    hbm = (
        terms.get("a_bytes", 0)
        + terms.get("out_bytes", 0)
        + terms.get("dispatch_bytes", 0)
        + terms.get("b_bytes", 0) / r
    )
    if not any(k in terms for k in ("a_bytes", "b_bytes", "out_bytes")):
        hbm = terms.get("hbm_bytes", 0)
    t_memory = hbm / coeffs.hbm_bytes_per_s
    t_collective = terms.get("collective_bytes", 0) / coeffs.link_bytes_per_s
    t_latency = (
        terms.get("collective_phases", 0) * coeffs.phase_latency_s
        + terms.get("kernel_invocations", 1) * coeffs.launch_overhead_s * amort
    )
    if terms.get("overlap"):
        # double-buffered ring: hops hidden behind kernel calls (§15)
        total = max(t_compute, t_memory, t_collective) + t_latency
    else:
        total = max(t_compute, t_memory) + t_collective + t_latency
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "t_latency_s": t_latency,
        "total_s": total,
    }


def predict_blocks_ms(
    m: int, k: int, n: int, blocks: Tuple[int, int, int], coeffs: CostCoefficients
) -> float:
    """Predicted milliseconds for one (bm, bn, bk)-blocked GEMM — the cost
    model's block scorer (lower is better, unlike autotune.model_score).

    The padded iteration space sets the compute term (overhang blocks do
    dead work) and per-phase streaming sets the memory term; used by
    the autotuner's optional cost-model ranking once coefficients are
    calibrated.
    """
    bm, bn, bk = blocks
    ceil = lambda a, b: -(-a // b)
    pm, pn, pk = ceil(m, bm) * bm, ceil(n, bn) * bn, ceil(k, bk) * bk
    flops = 2 * pm * pn * pk
    # every (i, j) cell streams its A row-block and B col-block per k phase
    phases = ceil(k, bk)
    bytes_streamed = ceil(m, bm) * ceil(n, bn) * phases * (bm * bk + bk * bn) * 4
    t = max(
        flops / coeffs.flops_per_s,
        bytes_streamed / coeffs.hbm_bytes_per_s,
    )
    return t * 1e3
