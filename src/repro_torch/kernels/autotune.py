"""Block-shape autotuner for the mesh GEMM's plans.

Port of `repro.kernels.autotune`.  The logical block triple (block_m,
block_n, block_k) fixes the mesh schedule of a product: which k block each
output cell visits at each step ((i + j + k) mod nk over logical blocks)
and where the sigma scramble places each cell — so it fixes the bits of
the result.  This module owns the choice, so plans never hard-code 128³:

  candidate_blocks   128-aligned triples (128, 256, 512 per dim), legal on
                     the platform (below)
  autotune           cache lookup -> (timed | model-scored) search over the
                     candidates, warm-started from the nearest cached shape
  AutotuneCache      versioned persistent JSON keyed by
                     (M, K, N, dtype, backend, symmetry, platform), the
                     reference's format; a legacy v1 flat dict migrates on
                     load
  resolve_blocks     process-memoized entry point used by `kernels/api.plan`
                     (through `costmodel.choose.choose_blocks`) whenever
                     block sizes aren't explicitly passed

Platforms are device types.

  cpu    candidates and scores are the reference's exactly: triples whose
         working set (`vmem_bytes`: A and B tiles, an f32 accumulator, the
         epilogue tiles) fits the reference planner's 12 MiB budget, ranked
         by `model_score`.  So a CPU plan takes the reference's blocks.
  cuda   on Hopper a logical block does not set shared memory; the tile
         family that K1's `tile_config` picks from the shapes and blocks
         does.  A candidate is legal only if it gives the product a
         tensor-core or `f32_128` tile (`tc_decode` for M <= 16), never a
         first SIMT tile, so the chooser never sends a product to those.
         `vmem_bytes` of a plan on the card (`Plan.describe()`) reports the
         shared memory of that tile (`TILE_SMEM_BYTES`).

Search modes: "time" runs the real kernel per candidate (device time:
CUDA events around launches queued behind a held stream, never the host's
launch time), "model" ranks by the analytic score intensity x
padding-utilization, "auto" picks "time" on the card and "model" on the
CPU.  A cache hit never searches.  A timed choice fixes the k order, so
the cache entry it writes decides the bits from then on.  So, unlike the
reference's plain minimum, the timed search keeps the best-ranked
candidate (by `model_score`, or the caller's scorer) among those within
`TIMED_MARGIN` of the fastest: the candidates of a product often lie
within timing noise of each other, and a pick by noise would give two
fresh processes on one card different bits for the same request.  With
the shipped coefficients the card's candidates and ranking are the CPU's,
so the card takes the reference's blocks (and k order) unless another
candidate is measurably faster.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.costmodel.calibrate import default_platform
from repro_torch.costmodel.model import ITEMSIZE
from repro_torch.kernels import grouped as _grouped
from repro_torch.kernels import mesh_matmul as _mm
from repro_torch.obs import trace as _obs
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import ledger as _rledger
from repro_torch.resilience.policy import retry_call as _retry_call

__all__ = [
    "CACHE_VERSION",
    "AutotuneCache",
    "autotune",
    "cache_key",
    "candidate_blocks",
    "clear_resolve_memo",
    "default_cache",
    "legal_on_card",
    "measure_best_ms",
    "model_score",
    "resolve_blocks",
    "tile_smem_bytes",
    "vmem_bytes",
]

CACHE_VERSION = 2
DEFAULT_CACHE_FILENAME = ".autotune_cache.json"
_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"

_LANE = 128  # every candidate dimension is a multiple
# The reference planner's per-cell working-set budget
# (`repro.kernels.autotune.DEFAULT_VMEM_BUDGET`): the CPU's candidates are
# pruned by it so that CPU plans take the reference's blocks.
DEFAULT_VMEM_BUDGET = 12 * 1024 * 1024
# The K1 tiles the chooser may send a product to on the card.
_CARD_TILES = ("tc128", "f32_128", "tc_decode")
# A timed candidate wins over a better-ranked one only when it is faster by
# more than this fraction of the fastest time.  On an NVIDIA H100 80GB HBM3
# (700 W) the candidates of mesh-paper's products read within 0.1-6 % of
# each other and the same candidate moves up to about 3 % between timings
# (chip_smoke.py [obs] (a) and (d)); at a 5 % margin two processes of
# chip_smoke.py still read different [serve_qwen2_moe] logits.
TIMED_MARGIN = 0.10
# Cycles the stream is held before a timed run (about 0.1 ms a call at the
# H100's 1.98 GHz boost clock), so every timed launch is queued before the
# first one starts and the events see device time only.
_HOLD_CYCLES_PER_CALL = 200_000

Blocks = Tuple[int, int, int]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cache_key(
    m: int,
    k: int,
    n: int,
    dtype,
    backend: str,
    *,
    symmetry: int = 0,
    platform: Optional[str] = None,
) -> str:
    """`"MxKxN|dtype|backend|symS|platform"` — the reference's key format."""
    platform = platform or default_platform()
    return f"{m}x{k}x{n}|{_dtype_name(dtype)}|{backend}|sym{symmetry}|{platform}"


def vmem_bytes(
    bm: int,
    bn: int,
    bk: int,
    dtype,
    *,
    has_bias: bool = False,
    has_residual: bool = False,
) -> int:
    """Per-cell working set of the reference's model: A-tile + B-tile + f32
    acc (+ epilogue)."""
    ds = ITEMSIZE[_dtype_name(dtype)]
    total = (bm * bk + bk * bn) * ds + bm * bn * 4
    if has_bias:
        total += bn * 4
    if has_residual:
        total += bm * bn * ds
    return total


def _card_tile(m: int, k: int, n: int, blocks: Blocks, dtype, backend: str) -> str:
    bm, bn, bk = blocks
    dt = getattr(torch, _dtype_name(dtype))
    kn = _mm.kernel_n(n, bn, dt, backend.endswith("_scrambled"))
    return _mm.tile_config(m, kn, k, bm, bn, bk, dt)


def legal_on_card(m: int, k: int, n: int, blocks: Blocks, dtype,
                  backend: str = "cuda_mesh") -> bool:
    """Whether K1 runs an (M, K) @ (K, N) product of `dtype` on `blocks` on
    a tensor-core or f32 tile, not a first SIMT tile."""
    return _card_tile(m, k, n, blocks, dtype, backend) in _CARD_TILES


def tile_smem_bytes(m: int, k: int, n: int, blocks: Blocks, dtype, *,
                    grouped: bool = False) -> int:
    """Shared memory of one CTA of the tile the card runs a product on: K1's
    tile, or K5's for a grouped product (m then the rows-per-group bound,
    blocks after the block_m clamp)."""
    bm, bn, bk = blocks
    if grouped:
        cfg = _grouped.tile_config(n, k, bm, bn, bk, getattr(torch, _dtype_name(dtype)))
        return _grouped.TILE_SMEM_BYTES[cfg]
    return _mm.TILE_SMEM_BYTES[_card_tile(m, k, n, blocks, dtype, "cuda_mesh")]


def _dim_candidates(dim: int, aligns: Tuple[int, ...]) -> List[int]:
    """Aligned block sizes that don't exceed the dim padded up to alignment."""
    ceil_dim = max(dim, aligns[0])
    out = [a for a in aligns if a <= ((ceil_dim + aligns[0] - 1) // aligns[0]) * aligns[0]]
    return out or [aligns[0]]


def candidate_blocks(
    m: int,
    k: int,
    n: int,
    dtype,
    *,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    aligns: Tuple[int, ...] = (_LANE, 2 * _LANE, 4 * _LANE),
    has_bias: bool = False,
    has_residual: bool = False,
    platform: str = "cpu",
    backend: str = "cuda_mesh",
) -> List[Blocks]:
    """Aligned (bm, bn, bk) triples legal on `platform`: within the working-
    set budget on the CPU, on a tensor-core or f32 tile on the card."""
    cands = [
        (bm, bn, bk)
        for bm in _dim_candidates(m, aligns)
        for bn in _dim_candidates(n, aligns)
        for bk in _dim_candidates(k, aligns)
    ]
    if platform == "cuda":
        cands = [c for c in cands if legal_on_card(m, k, n, c, dtype, backend)]
    else:
        cands = [
            c for c in cands
            if vmem_bytes(*c, dtype, has_bias=has_bias, has_residual=has_residual)
            <= vmem_budget
        ]
    if not cands:  # nothing legal: fall back anyway
        cands = [(aligns[0], aligns[0], aligns[0])]
    return cands


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def model_score(m: int, k: int, n: int, blocks: Blocks, dtype) -> float:
    """Analytic desirability: arithmetic intensity x padding utilization.

    intensity   = FLOPs per byte streamed for one (bm, bn, bk) phase —
                  rewards large blocks (the roofline x-axis).
    utilization = useful fraction of the padded iteration space — penalizes
                  blocks that overhang M/N/K (wasted work).
    """
    bm, bn, bk = blocks
    ds = ITEMSIZE[_dtype_name(dtype)]
    intensity = (2 * bm * bn * bk) / ((bm * bk + bk * bn) * ds)
    padded = (
        _ceil_div(m, bm) * bm * _ceil_div(n, bn) * bn * _ceil_div(k, bk) * bk
    )
    utilization = (m * n * k) / padded
    return intensity * utilization


class AutotuneCache:
    """Versioned persistent JSON cache of chosen block triples.

    On-disk format (v2, the reference's):
        {"version": 2, "entries": {key: {"blocks": [bm, bn, bk],
                                         "source": "timed|model|seed",
                                         "ms": float|null}}}
    A legacy v1 file (flat {key: [bm, bn, bk]}) is migrated in memory on
    load and rewritten as v2 on the next save.  Any other version is
    discarded rather than trusted.

    Resilience: an unreadable/corrupt cache file is QUARANTINED — warned
    about once (with the path), moved aside to `<path>.corrupt`, and
    recorded in the resilience ledger.  Entries are validated on load
    against their platform's legality (the working-set budget for `cpu`
    keys, a card tile for `cuda` keys): an entry that fails is dropped with
    a ledger record, and the next `autotune` miss rebuilds it.
    """

    def __init__(
        self,
        path: Optional[os.PathLike] = None,
        *,
        vmem_budget: int = DEFAULT_VMEM_BUDGET,
    ):
        self.path = Path(path or os.environ.get(_ENV_CACHE, DEFAULT_CACHE_FILENAME))
        self.vmem_budget = vmem_budget
        self._entries: Optional[Dict[str, dict]] = None

    # -- persistence ---------------------------------------------------------

    def _entry_legal(self, key: str, blocks) -> bool:
        """A cached triple must be legal where its key says it runs: the
        worst-case (epilogue) working set within the budget, or on the card
        a tensor-core or f32 tile.  Keys that don't parse are kept."""
        parts = key.split("|")
        if len(parts) != 5 or parts[1] not in ITEMSIZE:
            return True
        blocks = tuple(int(x) for x in blocks)
        if parts[4] == "cuda":
            try:
                m, k, n = (int(x) for x in parts[0].split("x"))
            except ValueError:
                return True
            return legal_on_card(m, k, n, blocks, parts[1], parts[2])
        return (
            vmem_bytes(*blocks, parts[1], has_bias=True, has_residual=True)
            <= self.vmem_budget
        )

    def _quarantine_file(self, err: BaseException) -> None:
        """Move the unreadable cache aside as `<path>.corrupt` so the bad
        file is diagnosable (and never re-read), then record + warn once."""
        corrupt = Path(str(self.path) + ".corrupt")
        moved = False
        try:
            os.replace(self.path, corrupt)
            moved = True
        except OSError:
            pass
        _warn_once(
            f"autotune cache {self.path} is unreadable"
            f" ({type(err).__name__}: {err});"
            + (f" moved aside to {corrupt};" if moved else "")
            + " retuning from scratch"
        )
        _rledger.record(
            "autotune.cache_load",
            cause=f"{type(err).__name__}: {err}",
            fallback="quarantine",
            path=str(self.path),
            moved_to=str(corrupt) if moved else None,
        )

    def _load(self) -> Dict[str, dict]:
        if self._entries is not None:
            return self._entries
        self._entries = {}
        try:
            _faults.check("autotune.cache_load", path=str(self.path))
            raw = json.loads(self.path.read_text())
        except FileNotFoundError:
            return self._entries  # first run: nothing to load, nothing to warn
        except (OSError, json.JSONDecodeError, _faults.FaultError) as e:
            self._quarantine_file(e)
            return self._entries
        dropped = []
        if isinstance(raw, dict) and "version" not in raw:
            # v1 legacy: flat {key: [bm, bn, bk]}
            for key, blocks in raw.items():
                if _valid_blocks(blocks) and self._entry_legal(key, blocks):
                    self._entries[key] = {
                        "blocks": [int(x) for x in blocks],
                        "source": "seed",
                        "ms": None,
                    }
                else:
                    dropped.append(key)
        elif isinstance(raw, dict) and raw.get("version") == CACHE_VERSION:
            for key, ent in raw.get("entries", {}).items():
                if (
                    isinstance(ent, dict)
                    and _valid_blocks(ent.get("blocks"))
                    and self._entry_legal(key, ent["blocks"])
                ):
                    self._entries[key] = ent
                else:
                    dropped.append(key)
        # unknown version: start clean (stale caches must not steer the search)
        if dropped:
            _warn_once(
                f"autotune cache {self.path}: quarantined {len(dropped)}"
                f" invalid entr{'y' if len(dropped) == 1 else 'ies'}"
                f" (failed block/legality validation); they will be retuned"
            )
            _rledger.record(
                "autotune.cache_load",
                cause=f"{len(dropped)} entries failed validation",
                fallback="retune",
                path=str(self.path),
                keys=dropped[:8],
            )
        return self._entries

    def save(self) -> None:
        """Best-effort persistence with bounded retry: an unwritable
        filesystem must never turn into a plan-time crash, so after the
        retries the final OSError is still swallowed (each retry is a ledger
        event, so persistent write failure stays visible)."""
        entries = self._load()
        payload = {"version": CACHE_VERSION, "entries": entries}

        def _write_once() -> None:
            tmp = None
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=str(self.path.parent), prefix=self.path.name, suffix=".tmp"
                )
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                raise

        try:
            _retry_call(
                _write_once,
                retries=2,
                base_delay=0.01,
                retry_on=(OSError,),
                site="autotune.cache_save",
            )
        except OSError:
            pass

    # -- access --------------------------------------------------------------

    def get(self, key: str) -> Optional[Blocks]:
        ent = self._load().get(key)
        return tuple(ent["blocks"]) if ent else None

    def put(
        self, key: str, blocks: Blocks, *, source: str, ms: Optional[float] = None
    ) -> None:
        self._load()[key] = {
            "blocks": [int(x) for x in blocks],
            "source": source,
            "ms": ms,
        }

    def keys(self) -> List[str]:
        return list(self._load())


_WARNED: set = set()


def _warn_once(msg: str) -> None:
    """One warning per distinct message per process."""
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


def _valid_blocks(blocks) -> bool:
    return (
        isinstance(blocks, (list, tuple))
        and len(blocks) == 3
        and all(isinstance(x, int) and x > 0 for x in blocks)
    )


_DEFAULT_CACHE: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    """Process-wide cache instance (respects $REPRO_AUTOTUNE_CACHE)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != Path(
        os.environ.get(_ENV_CACHE, DEFAULT_CACHE_FILENAME)
    ):
        _DEFAULT_CACHE = AutotuneCache()
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _warm_start(
    cache: AutotuneCache, m: int, k: int, n: int, dtype, backend: str, platform: str
) -> Optional[Blocks]:
    """Blocks of the nearest cached shape with the same dtype/backend/platform.

    Distance is L1 in log2 space over (M, K, N) — a 2048³ entry warm-starts a
    4096³ search better than a 512x512x128 one.
    """
    suffix = f"|{_dtype_name(dtype)}|{backend}|"
    best, best_d = None, float("inf")
    for key in cache.keys():
        if suffix not in key or not key.endswith(f"|{platform}"):
            continue
        try:
            mm, kk, nn = (int(x) for x in key.split("|", 1)[0].split("x"))
        except ValueError:
            continue
        d = sum(
            abs(np.log2(a) - np.log2(b))
            for a, b in zip((m, k, n), (mm, kk, nn))
        )
        if d < best_d:
            best, best_d = cache.get(key), d
    return best


def measure_best_ms(fn: Callable, *args, warmup: int = 1, reps: int = 3) -> float:
    """Best-of-`reps` time of `fn(*args)` in milliseconds, after `warmup`
    untimed calls — the timing utility behind the autotuner's candidate
    search, `costmodel/calibrate.py`'s probes and `hillclimb --gemm`.

    When an argument lies on the card this is device time: the stream is
    held by a sleep kernel while the `reps` calls are queued between CUDA
    events, so each interval between two events is one call's device work,
    not the host's launch time.  On the CPU, where the work is done when
    `fn` returns, it is wall time.
    """
    for _ in range(warmup):
        fn(*args)
    reps = max(1, reps)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        torch.cuda.synchronize()
        torch.cuda._sleep(_HOLD_CYCLES_PER_CALL * reps)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for ev in events[1:]:
            fn(*args)
            ev.record()
        events[-1].synchronize()
        return min(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _default_measure(
    m: int, k: int, n: int, dtype, backend: str, blocks: Blocks, *, platform: str = "cpu"
) -> float:
    """Time one real product on `blocks`, in milliseconds.  On the card: K1
    itself at the product's shape on seeded random operands, launched
    uncounted (`mesh_matmul._launch`), device time.  On the CPU: the plain
    version on zero operands padded to the blocks, as the reference times
    its kernel off its accelerator."""
    bm, bn, bk = blocks
    dt = getattr(torch, _dtype_name(dtype))
    scramble = backend.endswith("_scrambled")
    if platform == "cuda":
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
        kw = dict(bias=None, residual=None, block_m=bm, block_n=bn, block_k=bk,
                  stagger=True, scramble_out=scramble, activation=None, out_dtype=None,
                  sigma=None)
        return measure_best_ms(lambda x, y: _mm._launch(x, y, **kw), a, b)
    a = torch.zeros((_ceil_div(m, bm) * bm, _ceil_div(k, bk) * bk), dtype=dt)
    b = torch.zeros((_ceil_div(k, bk) * bk, _ceil_div(n, bn) * bn), dtype=dt)
    return measure_best_ms(
        lambda x, y: _mm.mesh_matmul_torch(x, y, block_m=bm, block_n=bn, block_k=bk,
                                           scramble_out=scramble), a, b)


def _scramble_compatible(m: int, n: int, blocks: Blocks) -> bool:
    """The scrambled backend needs block-aligned M/N and a square block grid
    (the σ table is defined on g x g cells) — padding is rejected at
    dispatch, so the search must never propose blocks that violate either."""
    bm, bn, _ = blocks
    return m % bm == 0 and n % bn == 0 and m // bm == n // bn


def autotune(
    m: int,
    k: int,
    n: int,
    dtype,
    backend: str = "cuda_mesh",
    *,
    symmetry: int = 0,
    platform: Optional[str] = None,
    cache: Optional[AutotuneCache] = None,
    mode: str = "auto",
    measure: Optional[Callable[..., float]] = None,
    max_timed: int = 8,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    scorer: Optional[Callable[[Blocks], float]] = None,
) -> Blocks:
    """Resolve the block triple for an (M, K, N) GEMM.  Cache hit => no search.

    mode="time": measure `max_timed` candidates (warm-start candidate first,
    then by descending model score) and keep the best-ranked one within
    `TIMED_MARGIN` of the fastest.  mode="model": pick
    the analytic argmax without running anything.  mode="auto": "time" on
    the card, "model" on the CPU.

    The cache key is shape-level only, so CPU candidate pruning budgets for
    the worst-case epilogue working set (bias + residual tiles) — a cached
    entry is valid for every epilogue configuration of that shape.

    `scorer` (optional) replaces the analytic `model_score` ranking with an
    external cost in milliseconds (LOWER is better) — the hook
    `costmodel/choose.py` uses to rank candidates by calibrated-coefficient
    predictions while the timed search stays the tie-breaker on the card.
    """
    platform = platform or default_platform()
    cache = cache or default_cache()
    key = cache_key(m, k, n, dtype, backend, symmetry=symmetry, platform=platform)
    hit = cache.get(key)
    if hit is not None:
        return hit

    if mode == "auto":
        mode = "time" if platform == "cuda" else "model"
    if mode not in ("time", "model"):
        raise ValueError(f"mode must be auto|time|model, got {mode!r}")

    cands = candidate_blocks(
        m,
        k,
        n,
        dtype,
        vmem_budget=vmem_budget,
        has_bias=True,
        has_residual=True,
        platform=platform,
        backend=backend,
    )
    if backend.endswith("_scrambled"):
        cands = [c for c in cands if _scramble_compatible(m, n, c)] or [
            (_LANE, _LANE, _LANE)  # dispatch raises its own clear error if
        ]  # even the default can't tile M/N squarely
    if scorer is not None:
        cands.sort(key=scorer)
    else:
        cands.sort(key=lambda blk: model_score(m, k, n, blk, dtype), reverse=True)

    if mode == "model":
        best, ms, source = cands[0], None, "model"
    else:
        rank = {blk: i for i, blk in enumerate(cands)}
        # Warm start: measure the nearest cached shape's blocks first, then
        # the analytically best remainder.
        warm = _warm_start(cache, m, k, n, dtype, backend, platform)
        if warm in cands:
            cands.remove(warm)
            cands.insert(0, warm)
        if measure is None:
            def measure(*a):
                return _default_measure(*a, platform=platform)
        timed: List[Tuple[float, Blocks]] = []
        failed = 0
        for blk in cands[:max_timed]:
            # A candidate that fails to build or run is skipped, not fatal.
            try:
                with _obs.span("autotune.measure", key=key, blocks=list(blk)) as sp:
                    cand_ms = measure(m, k, n, dtype, backend, blk)
                    sp.set("ms", cand_ms)
                timed.append((cand_ms, blk))
            except Exception as e:
                failed += 1
                _rledger.record(
                    "autotune.measure",
                    cause=f"{type(e).__name__}: {e}",
                    fallback="skip-candidate",
                    blocks=blk,
                )
        if timed:
            # the best-ranked candidate within the margin of the fastest
            fastest = min(t for t, _ in timed)
            ms, best = min((tb for tb in timed if tb[0] <= fastest * (1 + TIMED_MARGIN)),
                           key=lambda tb: rank[tb[1]])
            source = "timed"
        else:
            # every timed candidate failed: fall back to the model argmax
            best, ms, source = cands[0], None, "model"
            _rledger.record(
                "autotune.measure",
                cause=f"all {failed} timed candidates failed",
                fallback="model",
                key=key,
            )

    cache.put(key, best, source=source, ms=ms)
    cache.save()
    return best


_RESOLVE_MEMO: Dict[tuple, Blocks] = {}


def resolve_blocks(
    m: int, k: int, n: int, dtype, backend: str, *, symmetry: int = 0,
    platform: Optional[str] = None,
) -> Blocks:
    """The planner's entry point: memoized per process, cache-backed, timed
    on the card and model-scored on the CPU (mode="auto").  `symmetry=1`
    keys the symmetric-readout regime's own cache partition."""
    platform = platform or default_platform()
    memo_key = (m, k, n, _dtype_name(dtype), backend, symmetry, platform)
    got = _RESOLVE_MEMO.get(memo_key)
    if got is None:
        got = autotune(m, k, n, dtype, backend, symmetry=symmetry, platform=platform)
        _RESOLVE_MEMO[memo_key] = got
    return got


def clear_resolve_memo() -> None:
    """Test hook: drop the per-process memo (not the persistent cache)."""
    _RESOLVE_MEMO.clear()
