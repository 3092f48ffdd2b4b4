"""Plan/execute operator API: typed GEMM specs + capability-based backends.

Port of `repro.kernels.api`, trimmed to what the dense and MoE paths run.
Planning — resolve a backend against declared capabilities, fix the block
shapes, precompute the sigma table — is separated from execution,
a cached reusable callable that serving invokes per request:

    spec = GemmSpec.from_operands(a, b, epilogue=Epilogue(bias=True,
                                                          activation="gelu"))
    p = plan(spec, backend="cuda_mesh")   # validate + build, ONCE
    y = p(a, b, bias=bias)                # reuse; p is cached per spec

Backends:
  torch      plain f32-accumulating matmul + unfused epilogue (the
             reference's `xla`): on CUDA, bf16 x bf16 runs as one cuBLAS
             GEMM with an f32 output (`out_dtype`), as `xla` multiplies
             bf16 with preferred_element_type=f32; elsewhere, and for
             other dtypes, an f32 matmul of the operands cast to f32
  ref        f32 matmul of the upcast operands plus the sigma scramble
             done as a gather (the oracle)
  cuda_mesh  the mesh kernel K1 (`kernels/mesh_matmul.py`) — the reference's
             `pallas_mesh`: launched on CUDA tensors, its plain version on
             CPU tensors the way `pallas_mesh` runs interpret mode off-TPU

The planner also covers grouped (ragged-batch) GEMMs, the MoE experts:
attach a `GroupSpec` (num_groups, static rows-per-group bound; K/N shared)
via `GemmSpec.for_groups`, and `plan(spec)` returns a `GroupedPlan` taking
`(tokens, group_offsets, weights)`.  A backend executes such specs only
when it declares the `grouped` capability with a dedicated impl: `torch`
(a segment-masked `bmm`, the reference's `xla`), `ref` (a per-group loop)
and `cuda_mesh` (kernel K5, `kernels/grouped.py`).

The planner is sharding-aware: attach a frozen `ShardSpec` (device-mesh
axes + the mesh axes that partition M/K/N/batch/groups) and `plan(spec,
mesh=mesh)` returns a `ShardedPlan`: the same per-shard Plan, run SPMD (one
process per rank, each slicing its shard of the global operands by its
mesh coordinate) inside a collective schedule of `SCHEDULES` from
`parallel/collectives.py` and `parallel/systolic.py`, with the epilogue
applied after the collective.  `mesh=` without a ShardSpec lets the cost
model choose one (`costmodel.choose.decide_sharding`).  A ShardedPlan
takes and returns global tensors: each process gets the whole result,
assembled from the ranks' blocks.  An unsharded ShardSpec (every axis of
size 1) goes through the same path and equals the plain Plan bit for bit.
The mesh is a `DeviceMesh` over live ranks, or for resolution, `describe()`
and the cost model a plain (name, size) layout (`parallel/sharding.py`).
Under `fallback=True` a failed collective degrades the plan to replicated
(unsharded) execution of the same spec; the default raises.

Blocks: entries of `spec.blocks` left None are resolved for a backend
with the `autotune` capability (`cuda_mesh`), and for every scrambled
product, through the cost model's chooser
(`costmodel.choose.choose_blocks` over `kernels/autotune.py`), as the
reference does: on the CPU the reference's candidates and analytic score,
so CPU plans carry the reference's blocks; on the card a timed search over
candidates that K1 runs on a tensor-core or f32 tile.  The blocks fix K1's
k order and the sigma placement, so they fix the bits of the result.  The
scrambled regime and the symmetric one key their own cache partitions
(`cuda_mesh_scrambled`, `sym1`).  A grouped plan resolves the blocks of
its logical group shape (m = the rows-per-group bound) and clamps block_m
to divide that bound.

Backend choice: an explicit `backend=` is validated strictly; otherwise a
capable pinned default (`set_default`, the scoped `default_backend(...)`)
wins, then the capable set is ranked by the cost model
(`costmodel.choose.decide_backend`, per-platform backend efficiencies),
the legacy order torch -> cuda_mesh -> registration order breaking ties;
with the shipped coefficients that order is the choice on both platforms.
The ranking is recorded in `describe()["decision"]`.

Observability: with tracing on (`repro_torch.obs`), `plan()` opens a
`plan.build` span on a cache miss, every execution a `plan.execute` span
(with the cost-model `terms` the obs bridge turns into calibration records,
and on the card a pair of CUDA events around the execution), and
`dispatch` a `plan.dispatch` span.  With tracing off the whole cost is one
attribute check per execution.

Resilience.  `plan(spec, fallback=True)` resolves a capability-ordered
fallback chain (`FALLBACK_ORDER`: cuda_mesh -> torch -> ref) behind the
chosen backend: a failed plan build or execution falls to the next capable
backend, recording a `DegradationEvent` in the plan's `health`
(`describe()["health"]`) and in `resilience.ledger`; an execution-time
swap is permanent for that plan.  Spec-level `PlanValidationError`s never
fall back.  The opt-in `guard_nonfinite` samples outputs for NaN/Inf
after the epilogue with a `raise | fallback | zero_and_record` policy.
One stated divergence from the reference: `fallback` defaults to False
here (True there).  A CUDA tensor launches its kernel or raises unless the
caller asks for the ladder; `fallback` is part of the plan-cache key, so a
plan built without the ladder is never handed to a caller who asked for it.

Gradients.  Where autograd records (grad enabled, an operand requiring
grad), a dense plan of the `cuda_mesh`, `torch` or `ref` backend runs its
product as one dispatcher op, `repro_torch::gemm`, given the backend's name
and the plan's static options (`MMOpts`).  Its backward is the reference's
`_mm` VJP op for op (`mm_backward`) on the backend's own GEMM (K1 for
`cuda_mesh`, an f32 matmul for the plain backends): unscramble the
cotangent, recompute the pre-activation z with one plain f32 call where
there is an activation, then dA = dz·Bᵀ and dB = Aᵀ·dz as two more f32
GEMMs.  As one op the product is visible to a selective-checkpoint policy
whatever launches it (K1 through ctypes, cuBLAS, the CPU plain version), so
the `dots` remat (`models/transformer._remat`) keeps its output.  A
`cuda_mesh` grouped GEMM runs through `_GroupedMM`, whose backward is the
reference's `_gmm` VJP (`gmm_backward`): segment-mask the cotangent,
recompute z with one f32 grouped call where there is an activation,
dtokens = the grouped kernel on Wᵀ, and dW = one batched product over the
(G, rpg) view.  The other grouped backends are plain ops that autograd
differentiates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import ref
from repro_torch.kernels.grouped import grouped_mesh_matmul
from repro_torch.kernels.mesh_matmul import (
    ACTIVATIONS,
    GELU_A,
    GELU_C,
    mesh_matmul,
    sigma_block_table,
)
from repro_torch.kernels.scramble import scramble_blocks
from repro_torch.obs import trace as _obs
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import ledger as _rledger
from repro_torch.resilience.policy import (
    NonFiniteError,
    nonfinite_count,
    normalize_policy,
    scrub_nonfinite,
)

__all__ = [
    "DEFAULT_BLOCKS",
    "FALLBACK_ORDER",
    "STRUCTURES",
    "AsyncResult",
    "BackendCapabilities",
    "CapabilityError",
    "Epilogue",
    "GemmSpec",
    "GroupSpec",
    "GroupedPlan",
    "MMOpts",
    "Plan",
    "PlanValidationError",
    "SCHEDULES",
    "ShardSpec",
    "ShardedGroupedPlan",
    "ShardedPlan",
    "apply_epilogue",
    "backend_names",
    "clear_plan_cache",
    "default_backend",
    "default_epoch",
    "execute_async",
    "get_default",
    "get_capabilities",
    "gmm_backward",
    "mm_backward",
    "plan",
    "plan_cache_info",
    "register_backend",
    "set_default",
    "unregister_backend",
]

STRUCTURES = ("general", "symmetric", "scrambled")

# Collective schedules a ShardedPlan can run (the reference's):
#   replicated        no collective: M/N/batch partitions are purely local
#                     (each rank owns its C tile; all-None axes are the
#                     unsharded case)
#   allgather_a       A row-sharded on M; each rank computes its result chunk
#                     once and the f32 chunks circulate the ring
#                     (collectives.ring_allgather_matmul); output replicated
#   reduce_scatter_k  A/B sharded on K; partial products ring-reduced so each
#                     rank ends with its M/p row slice
#                     (collectives.matmul_ring_reducescatter)
#   ring_k            A/B sharded on K; the paper's 2n-1 staggered feed as p
#                     accumulator wavefronts around the ring
#                     (systolic.ring_systolic_kpass); output replicated
#   *_overlap         double-buffered twin of the base schedule: every hop is
#                     in flight while a product runs; bitwise-equal to the
#                     serial twin where the local product is the same.  The
#                     column-half variants (allgather_a/ring_k) build the
#                     per-shard plan at n/2: even N, axis size >= 2
#   pipeline          like reduce_scatter_k, with each rank's row block
#                     1F1B-microbatched (collectives.ring_pipeline_matmul);
#                     bitwise-equal to reduce_scatter_k
#   expert            grouped specs only: the group (expert) dim sharded over
#                     axis_g, each rank running the grouped kernel over its
#                     local groups; output rows group-sharded
SCHEDULES = (
    "replicated",
    "allgather_a",
    "allgather_a_overlap",
    "reduce_scatter_k",
    "reduce_scatter_k_overlap",
    "ring_k",
    "ring_k_overlap",
    "pipeline",
    "expert",
)


def _is_overlap_schedule(sched: str) -> bool:
    """True for schedules whose ring hops are double-buffered against
    products: the cost model prices their collective under max(compute,
    comm) instead of adding it."""
    return sched.endswith("_overlap") or sched == "pipeline"


def _pipeline_microbatches(eff_m: int, pk: int) -> int:
    """Microbatch count of the `pipeline` schedule: two chains per stage
    when the per-stage row block splits evenly (so the steady state always
    has one hop in flight behind one product), else one."""
    mb = eff_m // pk
    f = 2 if mb >= 2 and mb % 2 == 0 else 1
    return f * pk
# The blocks a plan without blocks (a plain backend's general product)
# hands to its op's static options: they set nothing there.
DEFAULT_BLOCKS = (128, 128, 128)

_DTYPE_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float64: "float64",
}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        dt = _DTYPE_NAMES.get(dt, str(dt))
    if dt not in _NAME_DTYPES:
        raise ValueError(f"unsupported dtype {dt!r}; known: {sorted(_NAME_DTYPES)}")
    return dt


# ---------------------------------------------------------------------------
# Typed specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """The fused-epilogue contract: y = act(AB + bias) + residual.

    Declares *which* epilogue operands exist — the tensors themselves are
    execution-time inputs, so one plan serves every bias/residual value.
    """

    bias: bool = False
    activation: Optional[str] = None
    residual: bool = False

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(k for k in ACTIVATIONS if k)},"
                f" got {self.activation!r}"
            )
        if self.activation == "none":
            object.__setattr__(self, "activation", None)

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.residual) and self.activation is None


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Ragged-batch structure of one grouped GEMM.

    `num_groups` weight slabs share K/N; tokens arrive concatenated
    group-major in a capacity layout with a STATIC `rows_per_group` bound —
    group g owns rows [g*rows_per_group, g*rows_per_group + size_g), where
    the runtime sizes ride in the `group_offsets` execution operand
    (cumulative counts, (num_groups+1,)).  Rows at or beyond a group's size
    are zero on output.  Hashable and frozen: part of the plan-cache key.
    """

    num_groups: int
    rows_per_group: int

    def __post_init__(self):
        object.__setattr__(self, "num_groups", int(self.num_groups))
        object.__setattr__(self, "rows_per_group", int(self.rows_per_group))
        if self.num_groups <= 0 or self.rows_per_group <= 0:
            raise ValueError(
                f"GroupSpec dims must be positive, got num_groups="
                f"{self.num_groups}, rows_per_group={self.rows_per_group}"
            )

    @property
    def rows(self) -> int:
        """Total (static) token rows of the capacity layout."""
        return self.num_groups * self.rows_per_group


Axes = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Device-mesh partition of one GEMM.

    `mesh_axes` pins the (name, size) layout of the device mesh the spec was
    built for: the spec stays hashable (it is part of the plan-cache key)
    and `plan(spec, mesh=...)` checks that the live mesh matches.  The axis
    fields name which mesh axis partitions each LOGICAL dim of (batch...,
    M, K) @ (K, N); None leaves that dim whole.  `schedule` pins a
    collective schedule from SCHEDULES, or "auto" lets the planner choose
    (the cost model, `costmodel.choose.decide_schedule`).

    `axis_k` must be a single axis name: the K collectives are 1D rings.
    `axis_m`/`axis_n`/`axis_batch` may be axis tuples under the replicated
    schedule, where they only slice the local tile.  `axis_g` (one axis)
    partitions the group dim of a GROUPED spec: the `expert` schedule.  A
    ShardSpec whose axes are all None or of size 1 (`ShardSpec.unsharded`)
    goes through the identical ShardedPlan path and reproduces the
    unsharded Plan bit for bit.
    """

    mesh_axes: Tuple[Tuple[str, int], ...]
    axis_m: Optional[Axes] = None
    axis_k: Optional[str] = None
    axis_n: Optional[Axes] = None
    axis_batch: Optional[Axes] = None
    axis_g: Optional[str] = None
    schedule: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "mesh_axes", tuple((str(n), int(s)) for n, s in self.mesh_axes))
        names = [n for n, _ in self.mesh_axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names in {self.mesh_axes}")
        if self.schedule not in ("auto",) + SCHEDULES:
            raise ValueError(
                f"schedule must be 'auto' or one of {SCHEDULES}, got {self.schedule!r}"
            )
        seen: List[str] = []
        for field in ("axis_m", "axis_k", "axis_n", "axis_batch", "axis_g"):
            v = getattr(self, field)
            if isinstance(v, list):
                v = tuple(v)
            if isinstance(v, tuple) and len(v) == 1:
                v = v[0]
            if field == "axis_k" and v is not None and not isinstance(v, str):
                raise ValueError(
                    f"axis_k must be a single mesh axis name (the K collectives are 1D"
                    f" rings), got {self.axis_k!r}"
                )
            if field == "axis_g" and v is not None and not isinstance(v, str):
                raise ValueError(
                    f"axis_g must be a single mesh axis name (the group dim shards over"
                    f" one EP axis), got {self.axis_g!r}"
                )
            object.__setattr__(self, field, v)
            for nm in (v,) if isinstance(v, str) else (v or ()):
                if nm not in names:
                    raise ValueError(f"{field}={nm!r} is not a mesh axis; mesh has {names}")
                if nm in seen:
                    raise ValueError(f"mesh axis {nm!r} partitions more than one GEMM dim")
                seen.append(nm)

    @classmethod
    def from_mesh(
        cls,
        mesh,
        *,
        m: Optional[Axes] = None,
        k: Optional[str] = None,
        n: Optional[Axes] = None,
        batch: Optional[Axes] = None,
        g: Optional[str] = None,
        schedule: str = "auto",
    ) -> "ShardSpec":
        """Partition over a mesh (a DeviceMesh or a (name, size) layout) by
        PHYSICAL axis names."""
        return cls(mesh_axes=tuple(mesh_shape(mesh).items()), axis_m=m, axis_k=k, axis_n=n,
                   axis_batch=batch, axis_g=g, schedule=schedule)

    @classmethod
    def from_rules(
        cls,
        mesh,
        rules,
        *,
        m: Optional[str] = None,
        k: Optional[str] = None,
        n: Optional[str] = None,
        batch: Optional[str] = None,
        g: Optional[str] = None,
        schedule: str = "auto",
    ) -> "ShardSpec":
        """Partition by LOGICAL axis names (e.g. m='batch', n='mlp',
        g='experts') mapped through a `parallel.sharding.ShardingRules`
        table; rule axes the mesh doesn't carry are dropped."""
        from repro_torch.parallel.sharding import _axes_on_mesh

        def phys(logical):
            return None if logical is None else _axes_on_mesh(mesh, rules.get(logical))

        return cls.from_mesh(mesh, m=phys(m), k=phys(k), n=phys(n), batch=phys(batch),
                             g=phys(g), schedule=schedule)

    @classmethod
    def unsharded(cls, mesh) -> "ShardSpec":
        """All dims whole: the degenerate ShardSpec that routes an unsharded
        product through the same ShardedPlan path."""
        return cls.from_mesh(mesh)

    def axis_size(self, axes: Optional[Axes]) -> int:
        """Product of mesh-axis sizes a partition maps to (1 for None)."""
        sizes = dict(self.mesh_axes)
        return math.prod(sizes[nm] for nm in ((axes,) if isinstance(axes, str) else (axes or ())))

    @property
    def is_trivial(self) -> bool:
        """True when every partition has size 1 (numerically unsharded)."""
        return all(self.axis_size(a) == 1 for a in (
            self.axis_m, self.axis_k, self.axis_n, self.axis_batch, self.axis_g))


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """Logical description of one GEMM: (batch..., M, K) @ (K, N) — or, when
    `batched_b`, (batch..., M, K) @ (batch..., K, N).

    `structure` names the paper regime of the product: general (C = AB),
    symmetric (caller asserts C = Cᵀ; square), scrambled (the output lands in
    the paper's sigma block arrangement).  `blocks` is an optional
    (bm, bn, bk) override; entries left None are resolved at plan time
    (the cost model's chooser, see the module docstring).  `repeats`
    is a caller hint (products run back to back with the same B); numerics
    are unaffected.  `shard` attaches a device-mesh partition (ShardSpec):
    `plan(spec, mesh=mesh)` then returns a ShardedPlan.  `group` attaches a
    GroupSpec, turning the spec into a grouped (ragged-batch) GEMM: (num_groups
    * rows_per_group, K) tokens against (num_groups, K, N) stacked weights,
    `m` the total row bound.  Hashable and frozen — specs are the plan-cache
    key.
    """

    m: int
    k: int
    n: int
    batch: Tuple[int, ...] = ()
    batched_b: bool = False
    dtype_a: str = "float32"
    dtype_b: str = "float32"
    out_dtype: Optional[str] = None
    structure: str = "general"
    epilogue: Epilogue = Epilogue()
    blocks: Optional[Tuple[Optional[int], Optional[int], Optional[int]]] = None
    stagger: bool = True
    shard: Optional[ShardSpec] = None
    repeats: int = 1
    group: Optional[GroupSpec] = None

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(
                f"structure must be one of {STRUCTURES}, got {self.structure!r}"
            )
        if min(self.m, self.k, self.n) <= 0:
            raise ValueError(f"dims must be positive, got {(self.m, self.k, self.n)}")
        if self.batched_b and not self.batch:
            raise ValueError("batched_b requires leading batch dims")
        if self.shard is not None and not isinstance(self.shard, ShardSpec):
            raise TypeError(f"shard must be a ShardSpec, got {type(self.shard).__name__}")
        if self.group is not None:
            if not isinstance(self.group, GroupSpec):
                raise TypeError(f"group must be a GroupSpec, got {type(self.group).__name__}")
            if self.structure != "general":
                raise ValueError(
                    "grouped specs are structure='general' only (the σ and symmetric"
                    f" regimes are defined on one product), got {self.structure!r}"
                )
            if self.batch or self.batched_b:
                raise ValueError(
                    "grouped specs carry their batching in the GroupSpec;"
                    " leading batch dims are not supported"
                )
            if self.m != self.group.rows:
                raise ValueError(
                    f"grouped spec m={self.m} must equal num_groups*rows_per_group="
                    f"{self.group.rows} (use GemmSpec.for_groups)"
                )
        object.__setattr__(self, "repeats", int(self.repeats))
        if self.repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {self.repeats}")
        object.__setattr__(self, "batch", tuple(int(d) for d in self.batch))
        object.__setattr__(self, "dtype_a", _dtype_name(self.dtype_a))
        object.__setattr__(self, "dtype_b", _dtype_name(self.dtype_b))
        if self.out_dtype is not None:
            object.__setattr__(self, "out_dtype", _dtype_name(self.out_dtype))
        if self.blocks is not None:
            if len(self.blocks) != 3:
                raise ValueError(f"blocks must be a (bm, bn, bk) triple, got {self.blocks!r}")
            bks = tuple(None if x in (None, 0) else int(x) for x in self.blocks)
            object.__setattr__(self, "blocks", None if bks == (None,) * 3 else bks)

    @classmethod
    def from_operands(
        cls,
        a: torch.Tensor,
        b: torch.Tensor,
        *,
        structure: str = "general",
        epilogue: Optional[Epilogue] = None,
        out_dtype=None,
        blocks=None,
        stagger: bool = True,
        shard: Optional[ShardSpec] = None,
        repeats: int = 1,
    ) -> "GemmSpec":
        """Spec for concrete operands; leading dims of `a` become the batch,
        shared with `b` when `b` carries the same leading dims."""
        if a.dim() < 2 or b.dim() < 2:
            raise ValueError(f"operands must be >= 2D, got {tuple(a.shape)} @ {tuple(b.shape)}")
        if a.shape[-1] != b.shape[-2]:
            raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
        batched_b = b.dim() > 2
        if batched_b and a.shape[:-2] != b.shape[:-2]:
            raise ValueError(f"batch dims mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
        return cls(
            m=a.shape[-2],
            k=a.shape[-1],
            n=b.shape[-1],
            batch=tuple(a.shape[:-2]),
            batched_b=batched_b,
            dtype_a=a.dtype,
            dtype_b=b.dtype,
            out_dtype=out_dtype,
            structure=structure,
            epilogue=epilogue or Epilogue(),
            blocks=blocks,
            stagger=stagger,
            shard=shard,
            repeats=repeats,
        )

    @classmethod
    def for_groups(
        cls,
        group: GroupSpec,
        k: int,
        n: int,
        *,
        dtype_a="float32",
        dtype_b="float32",
        out_dtype=None,
        epilogue: Optional[Epilogue] = None,
        blocks=None,
        stagger: bool = True,
        shard: Optional[ShardSpec] = None,
        repeats: int = 1,
    ) -> "GemmSpec":
        """Spec for a grouped GEMM: (group.rows, k) tokens in the capacity
        layout against (group.num_groups, k, n) stacked weights."""
        return cls(
            m=group.rows,
            k=k,
            n=n,
            dtype_a=dtype_a,
            dtype_b=dtype_b,
            out_dtype=out_dtype,
            epilogue=epilogue or Epilogue(),
            blocks=blocks,
            stagger=stagger,
            shard=shard,
            group=group,
            repeats=repeats,
        )

    @property
    def eff_m(self) -> int:
        """M after folding leading batch dims (b 2D folds batch into M)."""
        if self.batch and not self.batched_b:
            return math.prod(self.batch) * self.m
        return self.m

    @property
    def acc_dtype(self) -> str:
        return _dtype_name(
            torch.promote_types(_NAME_DTYPES[self.dtype_a], _NAME_DTYPES[self.dtype_b])
        )

    def resolved_out_dtype(self) -> str:
        return self.out_dtype or self.acc_dtype

    def flops(self) -> int:
        return 2 * math.prod(self.batch or (1,)) * self.m * self.k * self.n


# ---------------------------------------------------------------------------
# Capability-based backend registry
# ---------------------------------------------------------------------------


class CapabilityError(ValueError):
    """A spec asks for something the (chosen or only) backend cannot do."""


class PlanValidationError(ValueError):
    """The SPEC itself is malformed (misaligned scramble blocks, non-square
    symmetric product, ...): every backend must reject it."""


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a registered backend declares it can execute.

    structures        subset of STRUCTURES the impl can produce
    batching          fully-batched (B, M, K) @ (B, K, N) operands
    epilogue          the epilogue contract (fused or not)
    epilogue_fusion   the epilogue runs inside the kernel (provenance only)
    autotune          consumes resolved (bm, bn, bk) block shapes
    devices           device types the impl executes on
    sharding          its per-shard product composes under a collective
                      schedule, so specs with a ShardSpec can run through a
                      ShardedPlan
    grouped           executes ragged-batch specs carrying a GroupSpec
                      (requires a `grouped_impl` at registration)
    """

    structures: FrozenSet[str] = frozenset({"general"})
    batching: bool = False
    epilogue: bool = True
    epilogue_fusion: bool = False
    autotune: bool = False
    devices: FrozenSet[str] = frozenset({"cpu", "cuda"})
    sharding: bool = False
    grouped: bool = False

    def __post_init__(self):
        object.__setattr__(self, "structures", frozenset(self.structures))
        object.__setattr__(self, "devices", frozenset(self.devices))
        unknown = self.structures - set(STRUCTURES)
        if unknown:
            raise ValueError(f"unknown structures {sorted(unknown)}; known: {STRUCTURES}")


_CAP_FIELDS = {f.name for f in dataclasses.fields(BackendCapabilities)}

# impl(plan, a, b, bias, residual) -> tensor
BackendImpl = Callable[["Plan", torch.Tensor, torch.Tensor, Any, Any], torch.Tensor]
# grouped_impl(plan, tokens, group_offsets, weights, bias, residual) -> tensor
GroupedImpl = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class _Backend:
    name: str
    impl: BackendImpl
    caps: BackendCapabilities
    grouped_impl: Optional[GroupedImpl] = None


_REGISTRY: Dict[str, _Backend] = {}

# Plan cache: one entry per (spec, backend, device type, guard, fallback) ever planned
# (defined here because registration evicts from it).
_PLAN_CACHE: Dict[tuple, "Plan"] = {}
_PLAN_STATS = {"hits": 0, "misses": 0}


def _evict_plans(name: str) -> None:
    """Drop cached plans for one backend: a (re|un)registered impl must not
    keep serving stale executables; other backends' plans stay cached."""
    for key in [k for k in _PLAN_CACHE if k[1] == name]:
        del _PLAN_CACHE[key]


def register_backend(
    name: str,
    impl: BackendImpl,
    capabilities: Union[BackendCapabilities, Mapping[str, Any]],
    *,
    grouped_impl: Optional[GroupedImpl] = None,
    override: bool = False,
) -> None:
    """Register a GEMM backend under `name` with declared capabilities.

    `capabilities` is a BackendCapabilities or a mapping with only its field
    names — unknown keys are rejected so typos never grant an ability.
    Declaring the `grouped` capability requires a matching `grouped_impl`
    (the ragged-batch entry point has a different operand signature).
    Duplicate names are rejected unless `override=True`.
    """
    if not isinstance(capabilities, BackendCapabilities):
        unknown = set(capabilities) - _CAP_FIELDS
        if unknown:
            raise ValueError(
                f"unknown capabilities {sorted(unknown)}; known: {sorted(_CAP_FIELDS)}"
            )
        capabilities = BackendCapabilities(**capabilities)
    if capabilities.grouped and grouped_impl is None:
        raise ValueError(
            f"backend {name!r} declares the 'grouped' capability but provides no grouped_impl"
        )
    if name in _REGISTRY and not override:
        raise ValueError(f"backend {name!r} already registered (pass override=True to replace)")
    _REGISTRY[name] = _Backend(name, impl, capabilities, grouped_impl)
    _evict_plans(name)


def unregister_backend(name: str) -> None:
    if _REGISTRY.pop(name, None) is not None:
        _evict_plans(name)


def backend_names() -> List[str]:
    return list(_REGISTRY)


def get_capabilities(name: str) -> BackendCapabilities:
    return _require_backend(name).caps


def _require_backend(name: str) -> _Backend:
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}")
    return be


def _check_capabilities(spec: GemmSpec, be: _Backend, device: str) -> Optional[str]:
    """None if `be` can run `spec` on `device`; else a human-readable reason."""
    caps = be.caps
    if spec.structure not in caps.structures:
        return (
            f"backend {be.name!r} does not support structure {spec.structure!r}"
            f" (supports {sorted(caps.structures)})"
        )
    if spec.batched_b and not caps.batching:
        return f"backend {be.name!r} does not support fully-batched operands"
    if not spec.epilogue.is_identity and not caps.epilogue:
        return f"backend {be.name!r} does not support the fused-epilogue contract"
    if device not in caps.devices:
        return f"backend {be.name!r} runs on {sorted(caps.devices)}, not {device!r}"
    if spec.group is not None and not caps.grouped:
        return (
            f"backend {be.name!r} does not support grouped (ragged-batch) specs"
            " (no 'grouped' capability)"
        )
    if spec.shard is not None and not caps.sharding:
        return (
            f"backend {be.name!r} does not support device-mesh sharded specs"
            " (no 'sharding' capability)"
        )
    return None


# -- default backend (process default + scoped override) ---------------------

_DEFAULT_BACKEND: List[Optional[str]] = [None]  # None = capability-based choice
_DEFAULT_EPOCH: List[int] = [0]  # bumped on every default change (see ops.py)


def set_default(name: Optional[str]) -> None:
    """Install a process-wide default backend (None restores auto-choice)."""
    if name is not None:
        _require_backend(name)
    _DEFAULT_BACKEND[0] = name
    _DEFAULT_EPOCH[0] += 1


def get_default() -> Optional[str]:
    return _DEFAULT_BACKEND[0]


def default_epoch() -> int:
    """Monotonic counter of default-backend changes — lets the legacy shim
    detect that its recorded default has been superseded by a newer
    set_default/default_backend scope."""
    return _DEFAULT_EPOCH[0]


@contextlib.contextmanager
def default_backend(name: str):
    """Scoped default: `with default_backend("cuda_mesh"): ...` — the
    supported replacement for the mutable `set_default_backend` global."""
    prev = _DEFAULT_BACKEND[0]
    set_default(name)
    try:
        yield
    finally:
        set_default(prev)


def _choose_backend(spec: GemmSpec, device: str) -> Tuple[_Backend, Optional[Dict[str, Any]]]:
    """Capability + cost choice on `device`, returning (backend, decision
    provenance).

    A CAPABLE pinned default wins immediately (explicit user intent).
    Otherwise the capable set is ranked by the cost model's per-backend
    efficiency (`costmodel.choose.decide_backend`) on the device's
    platform; the legacy order torch (the `xla` stand-in) -> cuda_mesh ->
    registration order breaks exact ties, and with the shipped
    coefficients the predicted order IS that order.  A cost-model failure
    degrades to the first capable backend with a ledger record."""
    reasons = []
    capable: List[Tuple[str, int]] = []
    pinned = _DEFAULT_BACKEND[0]
    order = dict.fromkeys((*(() if pinned is None else (pinned,)), "torch", "cuda_mesh",
                           *_REGISTRY))
    for idx, name in enumerate(order):
        be = _REGISTRY.get(name)
        if be is None:
            continue
        reason = _check_capabilities(spec, be, device)
        if reason is not None:
            reasons.append(reason)
            continue
        if name == pinned:
            return be, None
        capable.append((name, idx))
    if not capable:
        raise CapabilityError(
            "no registered backend can execute this spec: " + "; ".join(reasons)
        )
    if len(capable) == 1:
        return _REGISTRY[capable[0][0]], None
    try:
        from repro_torch.costmodel import choose as _cm_choose

        chosen, dec = _cm_choose.decide_backend(spec, capable, platform=device)
        return _REGISTRY[chosen], dec.as_dict()
    except Exception as e:  # degraded: legacy first-capable
        _rledger.record(
            "costmodel.decide_backend",
            cause=f"{type(e).__name__}: {e}",
            fallback=capable[0][0],
        )
        return _REGISTRY[capable[0][0]], None


# Capability-ordered degradation ladder: when a backend's plan build or
# execution fails, a plan built with fallback=True falls to the next CAPABLE
# backend in this order (then any other registered backend, registration
# order).  ref sits last: slowest, but the oracle that can always run.
FALLBACK_ORDER = ("cuda_mesh", "torch", "ref")


def _fallback_chain(spec: GemmSpec, primary: _Backend, device: str) -> List[_Backend]:
    """`primary` plus every other backend capable of `spec`, fallback-ordered."""
    chain = [primary]
    for name in dict.fromkeys((*FALLBACK_ORDER, *_REGISTRY)):
        be = _REGISTRY.get(name)
        if be is None or be.name == primary.name:
            continue
        if _check_capabilities(spec, be, device) is None:
            chain.append(be)
    return chain


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------


def apply_epilogue(
    z: torch.Tensor,
    bias: Optional[torch.Tensor],
    activation: Optional[str],
    residual: Optional[torch.Tensor],
) -> torch.Tensor:
    """The epilogue contract as plain torch ops (f32 in, f32 out) — the
    unfused reference used by the torch/ref backends."""
    if bias is not None:
        z = z + bias.float()
    if activation not in (None, "none"):
        z = ACTIVATIONS[activation](z)
    if residual is not None:
        z = z + residual.float()
    return z


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _check_declared(spec: GemmSpec, bias, residual) -> None:
    """The epilogue operands passed must be the ones the spec declared."""
    epi = spec.epilogue
    for name, arr, declared in (
        ("bias", bias, epi.bias),
        ("residual", residual, epi.residual),
    ):
        if (arr is not None) != declared:
            state = "with" if declared else "without"
            raise ValueError(
                f"plan was built {state} {name}; pass a matching "
                f"Epilogue in the GemmSpec to change the contract"
            )


class AsyncResult:
    """Handle for a dispatched plan execution.

    `out` is the output tensor, possibly still being computed on the card;
    `block()` waits for it and returns it.  On CUDA the handle holds an
    event recorded on the current stream right after the enqueue, and
    `block()` waits on that event only; on the CPU the work is done when
    `dispatch` returns.
    """

    __slots__ = ("plan", "out", "_event")

    def __init__(self, plan: "Plan", out: torch.Tensor):
        self.plan = plan
        self.out = out
        self._event = None
        if out.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))

    def block(self) -> torch.Tensor:
        """Wait for the dispatched execution and return its result."""
        if self._event is not None:
            self._event.synchronize()
        return self.out


@dataclasses.dataclass
class Plan:
    """A resolved, reusable GEMM executable with provenance.

    Built once by `plan(spec)`; calling it runs the chosen backend with the
    blocks/tables fixed at plan time.  `device` is the device type the plan
    was built for; the sigma table is uploaded to a device once, on the
    plan's first call there.  `vmem_bytes` is the reference model's
    working set of the blocks on the CPU, and the shared memory of the
    kernel tile that runs the product on the card.
    """

    spec: GemmSpec
    backend: str
    capabilities: BackendCapabilities
    device: str
    blocks: Optional[Tuple[int, int, int]]
    out_dtype: str
    flops: int
    vmem_bytes: Optional[int] = None
    sigma_table: Optional[np.ndarray] = None
    # -- resilience state --
    # guard: opt-in non-finite output policy; health: DegradationEvents this
    # plan recorded (build-time fallbacks + execution-time degradations);
    # _chain: backend names still available below the active one.
    guard: Optional[str] = None
    guard_sample: Optional[int] = None
    # Cost-model decision provenance: why this backend was picked, with
    # per-candidate predicted seconds and the calibration's source.  None
    # when the backend was pinned.
    decision: Optional[Dict[str, Any]] = None
    health: List = dataclasses.field(default_factory=list)
    _chain: List[str] = dataclasses.field(default_factory=list, repr=False)
    _active: Optional[str] = dataclasses.field(default=None, repr=False)
    _fn: Optional[Callable] = dataclasses.field(default=None, repr=False)
    _sigma_dev: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)
    _obs_attrs_cache: Optional[Dict[str, Any]] = dataclasses.field(default=None, repr=False)

    @property
    def activation(self) -> Optional[str]:
        return self.spec.epilogue.activation

    @property
    def active_backend(self) -> str:
        """The backend actually executing: `backend` until an execution-time
        degradation swapped in a fallback."""
        return self._active or self.backend

    @property
    def executor(self) -> Callable:
        """The raw executor `(a, b, bias, residual) -> out` (grouped:
        `(tokens, group_offsets, weights, bias, residual)`), with no per-call
        validation, fault site or guard — for trusted hot loops."""
        return self._fn

    def sigma_on(self, device: torch.device) -> Optional[torch.Tensor]:
        """The sigma table on `device` (uploaded once per device)."""
        if self.sigma_table is None:
            return None
        key = str(device)
        t = self._sigma_dev.get(key)
        if t is None:
            t = torch.as_tensor(self.sigma_table, dtype=torch.int32, device=device)
            self._sigma_dev[key] = t
        return t

    def describe(self) -> Dict[str, Any]:
        """JSON-able provenance record (serving telemetry, the cost model's
        terms)."""
        grp = self.spec.group
        d = {
            "backend": self.backend,
            "device": self.device,
            "structure": self.spec.structure,
            "mkn": f"{self.spec.eff_m}x{self.spec.k}x{self.spec.n}",
            "dtypes": [self.spec.dtype_a, self.spec.dtype_b],
            "batch": list(self.spec.batch),
            "batched_b": self.spec.batched_b,
            "repeats": self.spec.repeats,
            "blocks": list(self.blocks) if self.blocks else None,
            "epilogue": {
                "bias": self.spec.epilogue.bias,
                "activation": self.activation,
                "residual": self.spec.epilogue.residual,
            },
            "fused_epilogue": self.capabilities.epilogue_fusion,
            "out_dtype": self.out_dtype,
            "flops": self.flops,
            "vmem_bytes": self.vmem_bytes,
            "grouped": None if grp is None else {
                "num_groups": grp.num_groups,
                "rows_per_group": grp.rows_per_group,
                "per_group_flops": 2 * grp.rows_per_group * self.spec.k * self.spec.n,
                # routing traffic: every token row is scattered in (K) and
                # its result gathered back out (N)
                "dispatch_bytes": grp.rows * (
                    self.spec.k * _NAME_DTYPES[self.spec.dtype_a].itemsize
                    + self.spec.n * _NAME_DTYPES[self.out_dtype].itemsize),
            },
            "health": {
                "active_backend": self.active_backend,
                "degraded": bool(self.health),
                "guard_nonfinite": self.guard,
                "fallback_chain": list(self._chain),
                "events": [e.as_dict() for e in self.health],
            },
        }
        if self.decision is not None:
            d["decision"] = self.decision
        return d

    def _check_operands(self, a, b, bias, residual):
        spec = self.spec
        want_a = spec.batch + (spec.m, spec.k)
        want_b = (spec.batch if spec.batched_b else ()) + (spec.k, spec.n)
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise ValueError(
                f"operands {tuple(a.shape)} @ {tuple(b.shape)} do not match plan spec "
                f"{want_a} @ {want_b}"
            )
        got_dt = (_dtype_name(a.dtype), _dtype_name(b.dtype))
        if got_dt != (spec.dtype_a, spec.dtype_b):
            raise ValueError(
                f"operand dtypes {got_dt} do not match plan spec "
                f"({spec.dtype_a}, {spec.dtype_b}); build a new GemmSpec"
            )
        if a.device.type != self.device or b.device != a.device:
            raise ValueError(
                f"plan was built for {self.device!r} tensors, got {a.device} @ {b.device}"
            )
        _check_declared(spec, bias, residual)
        if bias is not None and tuple(bias.shape) != (spec.n,):
            raise ValueError(f"bias must have shape ({spec.n},), got {tuple(bias.shape)}")
        want_res = spec.batch + (spec.m, spec.n)
        if residual is not None and tuple(residual.shape) != want_res:
            raise ValueError(f"residual must have shape {want_res}, got {tuple(residual.shape)}")

    def __call__(self, a, b, bias=None, residual=None) -> torch.Tensor:
        self._check_operands(a, b, bias, residual)
        return self._execute((a, b, bias, residual))

    def mm_opts(self) -> "MMOpts":
        """The static options of this plan's product (its VJP's)."""
        bm, bn, bk = self.blocks or DEFAULT_BLOCKS
        return MMOpts(bm, bn, bk, self.spec.stagger, self.spec.structure == "scrambled",
                      _NAME_DTYPES[self.out_dtype], self.activation)

    def dispatch(self, a, b, bias=None, residual=None) -> AsyncResult:
        """Enqueue an execution and return without waiting on the device.

        Validation and the enqueue happen now; the card computes in the
        background and `AsyncResult.block()` (or `execute_async` over a batch
        of independent plans) is the single sync point.  The enqueue runs
        under its own `plan.dispatch` span, not `plan.execute`, whose warm
        spans feed calibration.  A plan with a `guard_nonfinite` policy
        reads a count back to inspect its output, so its dispatch is
        effectively synchronous (the guard wins).
        """
        self._check_operands(a, b, bias, residual)
        return AsyncResult(self, self._dispatch((a, b, bias, residual)))

    def _dispatch(self, args: tuple) -> torch.Tensor:
        if _obs._STATE.enabled:
            with _obs.span("plan.dispatch", **self._obs_attrs()):
                return self._execute_impl(args)
        return self._execute_impl(args)

    # -- resilience ----------------------------------------------------------

    def _record(self, site: str, cause: str, fallback: str, **detail):
        """One DegradationEvent, in the plan's health AND the global ledger."""
        ev = _rledger.record(site, cause=cause, fallback=fallback, **detail)
        self.health.append(ev)
        return ev

    def _can_degrade(self) -> bool:
        return bool(self._chain)

    def _degrade(self, args: tuple, *, site: str, cause: str, original=None):
        """Fall to the next capable backend in the chain and run `args` there.

        On success the plan PERMANENTLY swaps its executor — a backend that
        failed (or produced NaN under the `fallback` guard policy) is not
        trusted again for this plan.  Exhausting the chain raises."""
        err = original
        while self._chain:
            name = self._chain.pop(0)
            self._record(site, cause, fallback=name, backend=self.active_backend)
            try:
                fb = plan(self.spec, backend=name, device=self.device, fallback=False)
                _faults.check(site, backend=name)
                out = fb._fn(*args)
            except PlanValidationError:
                raise
            except Exception as e:
                cause = f"{type(e).__name__}: {e}"
                err = e
                continue
            self._fn = fb._fn
            self._active = name
            return out
        raise RuntimeError(
            f"backend {self.active_backend!r} failed ({cause}) and the"
            f" fallback chain is exhausted for this spec"
        ) from err

    def _obs_attrs(self) -> Dict[str, Any]:
        """Span attributes of plan.execute / plan.dispatch, computed once per
        plan: backend and blocks provenance plus the cost-model `terms` the
        obs bridge turns into calibration records."""
        at = self._obs_attrs_cache
        if at is None:
            spec = self.spec
            at = {
                "backend": self.active_backend,
                "structure": spec.structure,
                "mkn": f"{spec.eff_m}x{spec.k}x{spec.n}",
                "key": f"{spec.eff_m}x{spec.k}x{spec.n}|{self.backend}",
                "blocks": list(self.blocks) if self.blocks else None,
                "schedule": getattr(self, "schedule", None),
            }
            try:
                from repro_torch.costmodel.model import terms_from_describe

                at["terms"] = terms_from_describe(self.describe())
            except Exception:
                pass  # spans still carry provenance without cost terms
            self._obs_attrs_cache = at
        return at

    def _execute(self, args: tuple) -> torch.Tensor:
        # Disabled tracing costs ONE attribute check here.
        if _obs._STATE.enabled:
            return self._execute_traced(args)
        return self._execute_impl(args)

    def _execute_traced(self, args: tuple) -> torch.Tensor:
        """The execution under a `plan.execute` span; on the card the span
        also carries CUDA events recorded around the execution, which the
        obs bridge reads at drain (recording them does not wait)."""
        with _obs.span("plan.execute", **self._obs_attrs()) as sp:
            if self.device != "cuda" or not isinstance(sp, _obs.Span):
                return self._execute_impl(args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._execute_impl(args)
            end.record()
            sp.events = (start, end)
            return out

    def _execute_impl(self, args: tuple) -> torch.Tensor:
        try:
            _faults.check("plan.execute", backend=self.active_backend)
            out = self._fn(*args)
        except (PlanValidationError, CapabilityError):
            raise
        except Exception as e:
            if not self._can_degrade():
                raise  # no ladder below this backend: its own error surfaces
            out = self._degrade(
                args, site="plan.execute", cause=f"{type(e).__name__}: {e}", original=e
            )
        out = _faults.poison("kernel.output", out, backend=self.active_backend)
        if self.guard is not None:
            out = self._apply_guard(out, args)
        return out

    def _apply_guard(self, out: torch.Tensor, args: tuple) -> torch.Tensor:
        """The post-epilogue non-finite guard (fused paths stay fused: the
        check wraps the executor's OUTPUT, never reaches into the kernel)."""
        if torch.compiler.is_compiling():
            # Under a torch.compile trace values are unknown: zero_and_record
            # becomes an unconditional scrub; raise/fallback cannot branch on
            # them, so the gap is recorded, not hidden.
            if self.guard == "zero_and_record":
                return scrub_nonfinite(out)
            self._record(
                "guard.nonfinite",
                cause="guard bypassed under trace (values unknown)",
                fallback="unchecked",
                backend=self.active_backend,
            )
            return out
        bad = nonfinite_count(out, sample=self.guard_sample)
        if not bad:
            return out
        cause = f"{bad} non-finite output value(s) sampled"
        if self.guard == "zero_and_record":
            self._record("guard.nonfinite", cause, fallback="zero", backend=self.active_backend)
            return scrub_nonfinite(out)
        if self.guard == "fallback":
            out = self._degrade(args, site="guard.nonfinite", cause=cause)
            if not nonfinite_count(out, sample=self.guard_sample):
                return out
            raise NonFiniteError(
                f"non-finite outputs persist after fallback (backend {self.active_backend!r})"
            )
        raise NonFiniteError(
            f"guarded plan produced {bad} non-finite value(s) on backend"
            f" {self.active_backend!r} (structure={self.spec.structure!r},"
            f" mkn={self.spec.eff_m}x{self.spec.k}x{self.spec.n})"
        )


class _MatmulF32Out(torch.autograd.Function):
    """bf16 x bf16 -> f32 on CUDA: one cuBLAS GEMM with an f32 output
    (`torch.mm`/`torch.bmm` with `out_dtype`), products exact and sums in
    f32 as the reference's `xla` backend does them.  That op has no
    derivative, so the backward is spelled out with the contract of
    `mm_backward` (and of autograd through the upcast path): f32 GEMMs of
    the cotangent against the upcast operands, each gradient cast to its
    operand's dtype.  `b` is (K, N), folding `a`'s leading dims into M, or
    batched (B, K, N) against `a` (B, M, K)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        f32 = torch.float32
        if b.dim() == 2:
            z = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        else:
            z = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]), out_dtype=f32)
        return z.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                k, n = b.shape
                db = torch.matmul(a.float().reshape(-1, k).t(), g.reshape(-1, n))
            else:
                db = torch.matmul(a.float().transpose(-1, -2), g)
            db = db.to(b.dtype)
        return da, db


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result (the `torch` backend's
    GEMM): bf16 operands on CUDA go to the tensor cores through
    `_MatmulF32Out`; everything else is an f32 matmul of the upcast operands
    (this torch's `aten::mm.dtype` has no CPU kernel)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32Out.apply(a, b)
    return torch.matmul(a.float(), b.float())


def _torch_forward(a, b, bias, residual, opts: "MMOpts", sigma):
    z = _matmul_f32(a, b)
    return apply_epilogue(z, bias, opts.activation, residual).to(opts.out_dtype)


def _ref_forward(a, b, bias, residual, opts: "MMOpts", sigma):
    """Plain-torch oracle backend: same contract, no kernel — registered
    through the same capability door as the real kernel."""
    y = apply_epilogue(torch.matmul(a.float(), b.float()), bias, opts.activation, residual)
    if opts.scramble:
        y = ref.scramble_blocks_ref(y, block_m=opts.block_m, block_n=opts.block_n)
    return y.to(opts.out_dtype)


# d/dz of each fused activation as a function of the pre-activation z (the
# backward recomputes z — remat, not an extra forward output).
def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """Analytic derivative of ACTIVATIONS['gelu'] (same GELU_C/GELU_A)."""
    u = torch.tanh(GELU_C * (z + GELU_A * z**3))
    return 0.5 * (1 + u) + 0.5 * z * (1 - u**2) * GELU_C * (1 + 3 * GELU_A * z**2)


_ACT_GRADS = {
    "relu": lambda z: (z > 0).to(z.dtype),
    "silu": lambda z: torch.sigmoid(z) * (1 + z * (1 - torch.sigmoid(z))),
    "sigmoid": lambda z: torch.sigmoid(z) * (1 - torch.sigmoid(z)),
    "tanh": lambda z: 1 - torch.tanh(z) ** 2,
    "gelu": _gelu_grad,
}


@dataclasses.dataclass(frozen=True)
class MMOpts:
    """The static options of one mesh GEMM (the reference's `_mm` opts); a
    grouped GEMM's (`_gmm` opts) have `scramble` False."""

    block_m: int
    block_n: int
    block_k: int
    stagger: bool
    scramble: bool
    out_dtype: torch.dtype
    activation: Optional[str]


def mm_backward(
    g: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    bias: Optional[torch.Tensor],
    res_dtype: Optional[torch.dtype],
    opts: MMOpts,
    matmul: Callable = mesh_matmul,
):
    """The mesh GEMM's VJP, op for op the reference's `_mm_bwd`.

    `matmul` is the GEMM it runs (mesh_matmul's signature): the kernel
    wrapper in training, `mesh_matmul_torch` to hold the kernel's backward
    against the plain one on the same device.  Returns (dA, dB, dbias,
    dresidual), each in its operand's dtype (None where there is none).
    """
    bm, bn, bk = opts.block_m, opts.block_n, opts.block_k
    if opts.scramble:
        # The permutation's transpose is its inverse: a pure gather (K3 on
        # the card), so the rest of the backward runs in standard order.
        g = scramble_blocks(g, block_m=bm, block_n=bn, k=-1)
    gf = g.float()
    dresidual = None if res_dtype is None else g.to(res_dtype)
    f32 = dict(stagger=opts.stagger, out_dtype=torch.float32)
    if opts.activation in (None, "none"):
        dz = gf
    else:
        # Remat z = A·B + bias with one plain (no epilogue, unscrambled) call.
        z = matmul(a2.float(), b2.float(), block_m=bm, block_n=bn, block_k=bk, **f32)
        if bias is not None:
            z = z + bias.float()
        dz = gf * _ACT_GRADS[opts.activation](z)
    b_t = b2.transpose(-1, -2).float()
    a_t = a2.transpose(-1, -2).float()
    da = matmul(dz, b_t, block_m=bm, block_n=bk, block_k=bn, **f32)
    db = matmul(a_t, dz, block_m=bk, block_n=bn, block_k=bm, **f32)
    dbias = None if bias is None else dz.sum(dim=tuple(range(dz.dim() - 1))).to(bias.dtype)
    return da.to(a2.dtype), db.to(b2.dtype), dbias, dresidual


def _mesh_forward(a, b, bias, residual, opts: MMOpts, sigma):
    """K1: 2D, batch-folded 2D (leading dims of `a` folded into M), or fully
    batched (one launch, blockIdx.z)."""
    shape = (*a.shape[:-1], b.shape[-1])
    lead = 2 if b.dim() == 2 else 3
    a2 = a.reshape(-1, *a.shape[1 - lead:])
    b2 = b.reshape(-1, *b.shape[-2:]) if lead == 3 else b
    res = None if residual is None else residual.reshape(-1, *residual.shape[1 - lead:])
    out = mesh_matmul(
        a2, b2, bias=bias, residual=res, block_m=opts.block_m, block_n=opts.block_n,
        block_k=opts.block_k, stagger=opts.stagger, scramble_out=opts.scramble,
        activation=opts.activation, out_dtype=opts.out_dtype, sigma=sigma,
    )
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# The dense product as one dispatcher op, `repro_torch::gemm`
# ---------------------------------------------------------------------------

_DENSE_FORWARD = {"cuda_mesh": _mesh_forward, "torch": _torch_forward, "ref": _ref_forward}


def _dense_forward(backend: str, a, b, bias, residual, opts: MMOpts, sigma):
    """The product of a built-in dense backend, with its epilogue."""
    return _DENSE_FORWARD[backend](a, b, bias, residual, opts, sigma)


@torch.library.custom_op(
    "repro_torch::gemm", mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor? bias, Tensor? residual, Tensor? sigma, str backend,"
           " int[] blocks, bool stagger, bool scramble, ScalarType out_dtype,"
           " str? activation) -> Tensor",
)
def _gemm_op(a, b, bias, residual, sigma, backend, blocks, stagger, scramble, out_dtype,
             activation):
    opts = MMOpts(*blocks, stagger, scramble, out_dtype, activation)
    return _dense_forward(backend, a, b, bias, residual, opts, sigma)


@_gemm_op.register_fake
def _gemm_op_fake(a, b, bias, residual, sigma, backend, blocks, stagger, scramble, out_dtype,
                  activation):
    return a.new_empty((*a.shape[:-1], b.shape[-1]), dtype=out_dtype)


def _plain_f32_matmul(a, b, **_):
    """`mm_backward`'s GEMM for the plain backends: its operands are f32."""
    return torch.matmul(a, b)


def _gemm_op_setup(ctx, inputs, output):
    a, b, bias, residual, _, backend, blocks, stagger, scramble, out_dtype, activation = inputs
    ctx.backend = backend
    ctx.opts = MMOpts(*blocks, stagger, scramble, out_dtype, activation)
    ctx.res_dtype = None if residual is None else residual.dtype
    ctx.save_for_backward(a, b, bias)


def _gemm_op_backward(ctx, g):
    """`mm_backward` on K1 for `cuda_mesh` and on an f32 `torch.matmul` for
    the plain backends; a 2-D B folds `a`'s leading dims into M, a batched
    B runs it batched."""
    a, b, bias = ctx.saved_tensors
    matmul = mesh_matmul if ctx.backend == "cuda_mesh" else _plain_f32_matmul
    if b.dim() == 2:
        a2, b2, g2 = a.reshape(-1, a.shape[-1]), b, g.reshape(-1, g.shape[-1])
    else:
        a2, b2 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
        g2 = g.reshape(-1, *g.shape[-2:])
    da, db, dbias, dres = mm_backward(g2, a2, b2, bias, ctx.res_dtype, ctx.opts, matmul=matmul)
    dres = None if dres is None else dres.reshape(g.shape)
    return (da.reshape(a.shape), db.reshape(b.shape), dbias, dres) + (None,) * 7


_gemm_op.register_autograd(_gemm_op_backward, setup_context=_gemm_op_setup)


def _dense_impl(backend: str) -> Callable:
    """The executor of a built-in dense backend: its product, as the op
    `repro_torch::gemm` where autograd records it."""

    def impl(p: Plan, a, b, bias, residual):
        opts = p.mm_opts()
        sigma = p.sigma_on(a.device) if backend == "cuda_mesh" else None
        operands = (a, b, bias, residual)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
            return _gemm_op(a, b, bias, residual, sigma, backend,
                            [opts.block_m, opts.block_n, opts.block_k], opts.stagger,
                            opts.scramble, opts.out_dtype, opts.activation)
        return _dense_forward(backend, a, b, bias, residual, opts, sigma)

    return impl


# ---------------------------------------------------------------------------
# Grouped (ragged-batch) GEMMs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroupedPlan(Plan):
    """A Plan for a grouped (ragged-batch) GEMM.

    Execution takes `(tokens, group_offsets, weights)` — tokens in the
    group-major capacity layout, `group_offsets` the (num_groups+1,)
    cumulative valid-row counts whose diffs are the per-group sizes, weights
    stacked (num_groups, K, N), bias per group (num_groups, N).  Rows at or
    beyond a group's size come back zero.  One plan serves every routing
    outcome of its logical group shape: the offsets are an execution-time
    operand, not part of the spec.
    """

    def _check_grouped_operands(self, tokens, group_offsets, weights, bias, residual):
        spec, grp = self.spec, self.spec.group
        want_t = (grp.rows, spec.k)
        want_w = (grp.num_groups, spec.k, spec.n)
        if tuple(tokens.shape) != want_t or tuple(weights.shape) != want_w:
            raise ValueError(
                f"grouped operands {tuple(tokens.shape)} / {tuple(weights.shape)} do not"
                f" match plan spec tokens {want_t} / weights {want_w}"
            )
        if tuple(group_offsets.shape) != (grp.num_groups + 1,):
            raise ValueError(
                f"group_offsets must have shape ({grp.num_groups + 1},) — cumulative row"
                f" counts — got {tuple(group_offsets.shape)}"
            )
        if group_offsets.dtype.is_floating_point or group_offsets.dtype == torch.bool:
            raise ValueError(f"group_offsets must be integer-typed, got {group_offsets.dtype}")
        got_dt = (_dtype_name(tokens.dtype), _dtype_name(weights.dtype))
        if got_dt != (spec.dtype_a, spec.dtype_b):
            raise ValueError(
                f"operand dtypes {got_dt} do not match plan spec "
                f"({spec.dtype_a}, {spec.dtype_b}); build a new GemmSpec"
            )
        if tokens.device.type != self.device or any(
            t.device != tokens.device for t in (group_offsets, weights)
        ):
            raise ValueError(
                f"plan was built for {self.device!r} tensors, got {tokens.device},"
                f" {group_offsets.device}, {weights.device}"
            )
        _check_declared(spec, bias, residual)
        if bias is not None and tuple(bias.shape) != (grp.num_groups, spec.n):
            raise ValueError(
                f"grouped bias must have shape ({grp.num_groups}, {spec.n}),"
                f" got {tuple(bias.shape)}"
            )
        if residual is not None and tuple(residual.shape) != (grp.rows, spec.n):
            raise ValueError(
                f"residual must have shape ({grp.rows}, {spec.n}), got {tuple(residual.shape)}"
            )

    def __call__(self, tokens, group_offsets, weights, bias=None, residual=None):
        self._check_grouped_operands(tokens, group_offsets, weights, bias, residual)
        return self._execute((tokens, group_offsets, weights, bias, residual))

    def dispatch(self, tokens, group_offsets, weights, bias=None, residual=None) -> AsyncResult:
        self._check_grouped_operands(tokens, group_offsets, weights, bias, residual)
        return AsyncResult(self, self._dispatch((tokens, group_offsets, weights, bias, residual)))


def _grouped_sizes(group_offsets: torch.Tensor) -> torch.Tensor:
    """Per-group sizes from the cumulative offsets: a diff on the offsets'
    device, so the host never reads routing data."""
    return (group_offsets[1:] - group_offsets[:-1]).to(torch.int32)


def _grouped_valid_mask(sizes: torch.Tensor, n_groups: int, rpg: int) -> torch.Tensor:
    """(rows, 1) f32 segment mask: 1 for rows inside their group's size."""
    valid = torch.arange(rpg, device=sizes.device)[None, :] < sizes[:, None]
    return valid.reshape(n_groups * rpg, 1).float()


def _torch_grouped_impl(p: Plan, tokens, group_offsets, w, bias, residual):
    """Segment-masked batched product (the reference's `xla` grouped impl):
    the capacity layout makes the ragged batch a dense (G, rpg, K) @
    (G, K, N) product; the mask zeroes rows past each group's size."""
    grp = p.spec.group
    rpg = grp.rows_per_group
    z = _matmul_f32(tokens.reshape(grp.num_groups, rpg, p.spec.k), w)
    z = apply_epilogue(
        z,
        None if bias is None else bias[:, None, :],
        p.activation,
        None if residual is None else residual.reshape(z.shape),
    )
    valid = torch.arange(rpg, device=tokens.device)[None, :] < _grouped_sizes(group_offsets)[:, None]
    z = torch.where(valid[..., None], z, 0.0)
    return z.reshape(grp.rows, p.spec.n).to(_NAME_DTYPES[p.out_dtype])


def _ref_grouped_impl(p: Plan, tokens, group_offsets, w, bias, residual):
    """Oracle: one plain product per group in a Python loop, same epilogue
    and segment-mask contract as every other grouped backend."""
    grp = p.spec.group
    sizes = _grouped_sizes(group_offsets)
    rpg = grp.rows_per_group
    rows_idx = torch.arange(rpg, device=tokens.device)[:, None]
    outs = []
    for g in range(grp.num_groups):
        sl = slice(g * rpg, (g + 1) * rpg)
        z = apply_epilogue(
            torch.matmul(tokens[sl].float(), w[g].float()),
            None if bias is None else bias[g],
            p.activation,
            None if residual is None else residual[sl],
        )
        outs.append(torch.where(rows_idx < sizes[g], z, 0.0))
    return torch.cat(outs, dim=0).to(_NAME_DTYPES[p.out_dtype])


def gmm_backward(
    g: torch.Tensor,
    tokens: torch.Tensor,
    sizes: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor],
    res_dtype: Optional[torch.dtype],
    opts: MMOpts,
    matmul: Callable = grouped_mesh_matmul,
):
    """The grouped GEMM's VJP, op for op the reference's `_gmm_bwd`.

    The cotangent is segment-masked (the forward zeroed padding rows),
    dz = g·act'(z) with z recomputed by one plain f32 grouped call,
    dtokens = grouped(dz, Wᵀ) reuses the ragged kernel with the N/K block
    roles swapped, and dW is one batched product over the (G, rpg) view,
    padding rows contributing exact zeros.  `matmul` is the grouped GEMM it
    runs (grouped_mesh_matmul's signature): the kernel wrapper in training,
    `grouped_mesh_matmul_torch` to hold the kernel's backward against the
    plain one.  Returns (dtokens, dW, dbias, dresidual), each in its
    operand's dtype (None where there is none).
    """
    bm, bn, bk = opts.block_m, opts.block_n, opts.block_k
    n_groups, _, n = w.shape
    rpg = tokens.shape[0] // n_groups
    mask = _grouped_valid_mask(sizes, n_groups, rpg)
    gf = g.float() * mask
    dresidual = None if res_dtype is None else gf.to(res_dtype)
    f32 = dict(stagger=opts.stagger, out_dtype=torch.float32)
    if opts.activation in (None, "none"):
        dz = gf
    else:
        z = matmul(tokens.float(), sizes, w.float(), block_m=bm, block_n=bn, block_k=bk, **f32)
        if bias is not None:
            z = (z.reshape(n_groups, rpg, n) + bias[:, None, :].float()).reshape(-1, n)
        dz = gf * _ACT_GRADS[opts.activation](z)  # gf already carries the mask
    w_t = w.transpose(-1, -2).float()
    dtokens = matmul(dz, sizes, w_t, block_m=bm, block_n=bk, block_k=bn, **f32)
    dw = torch.einsum(
        "grk,grn->gkn",
        (tokens.float() * mask).reshape(n_groups, rpg, -1),
        dz.reshape(n_groups, rpg, n),
    )
    dbias = None if bias is None else dz.reshape(n_groups, rpg, n).sum(dim=1).to(bias.dtype)
    return dtokens.to(tokens.dtype), dw.to(w.dtype), dbias, dresidual


class _GroupedMM(torch.autograd.Function):
    """K5 forward with the reference's `_gmm` VJP as its backward."""

    @staticmethod
    def forward(ctx, tokens, sizes, w, bias, residual, opts: MMOpts):
        ctx.opts = opts
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(tokens, sizes, w, bias)
        return grouped_mesh_matmul(
            tokens, sizes, w, bias=bias, residual=residual, block_m=opts.block_m,
            block_n=opts.block_n, block_k=opts.block_k, stagger=opts.stagger,
            activation=opts.activation, out_dtype=opts.out_dtype,
        )

    @staticmethod
    def backward(ctx, g):
        tokens, sizes, w, bias = ctx.saved_tensors
        dtokens, dw, dbias, dresidual = gmm_backward(
            g, tokens, sizes, w, bias, ctx.res_dtype, ctx.opts
        )
        return dtokens, None, dw, dbias, dresidual, None


def _cuda_mesh_grouped_impl(p: Plan, tokens, group_offsets, w, bias, residual):
    """K5, differentiable through `_GroupedMM`."""
    bm, bn, bk = p.blocks
    opts = MMOpts(bm, bn, bk, p.spec.stagger, False, _NAME_DTYPES[p.out_dtype], p.activation)
    return _GroupedMM.apply(tokens, _grouped_sizes(group_offsets), w, bias, residual, opts)


# ---------------------------------------------------------------------------
# Sharded plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedPlan(Plan):
    """A Plan run over a device mesh.

    Built by `plan(spec, mesh=...)` for a spec carrying a ShardSpec: the
    per-shard product is the ordinary single-device Plan (`local`, built by
    the same planner), run SPMD inside the chosen collective schedule.
    Operands and result are GLOBAL tensors with the spec's logical shapes,
    validated as for an unsharded Plan; each rank slices its shard by its
    mesh coordinate and every rank returns the whole result.  The epilogue
    is applied after the collective (act(sum) != sum(act) under a K split),
    so it is never kernel-fused here.

    Provenance: the collective `schedule`, per-shard FLOPs and memory via
    `local`, `bytes_moved` (collective link bytes per rank per call),
    `collective_phases` and `kernel_invocations` (per rank per call).
    `fallback` (plan(..., fallback=True)) lets a failed collective degrade
    to replicated execution of the same spec; otherwise it raises.
    """

    mesh: Any = None
    schedule: str = "replicated"
    local: Optional[Plan] = dataclasses.field(default=None, repr=False)
    bytes_moved: int = 0
    collective_phases: int = 0
    # Per-rank local product calls of one execution: reduce-scatter p,
    # column-half overlap twins 2, pipeline its microbatch count, else 1.
    kernel_invocations: int = 1
    # Measured serial_ms / overlap_ms of this schedule against its serial
    # twin, recorded by `note_overlap_efficiency`; provenance only.
    overlap_efficiency: Optional[float] = None
    fallback: bool = False

    def note_overlap_efficiency(self, ratio: float) -> None:
        """Record a measured serial/overlap time ratio (>1: the
        double-buffered schedule won); shows in describe()["sharding"]."""
        self.overlap_efficiency = float(ratio)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        shard = self.spec.shard
        d["fused_epilogue"] = False  # applied post-collective, never in-kernel
        d["sharding"] = {
            "mesh": [[n, s] for n, s in shard.mesh_axes],
            "axes": {"m": shard.axis_m, "k": shard.axis_k, "n": shard.axis_n,
                     "batch": shard.axis_batch, "g": shard.axis_g},
            "schedule": self.schedule,
            "overlap": _is_overlap_schedule(self.schedule),
            "overlap_efficiency": self.overlap_efficiency,
            "collective_phases": self.collective_phases,
            "bytes_moved": self.bytes_moved,
            "kernel_invocations": self.kernel_invocations,
            "per_shard_mkn": [self.local.spec.eff_m, self.local.spec.k, self.local.spec.n],
            "per_shard_batch": list(self.local.spec.batch),
            "per_shard_flops": self.local.flops * self.kernel_invocations,
            "per_shard_vmem_bytes": self.local.vmem_bytes,
        }
        return d

    def _can_degrade(self) -> bool:
        return self.fallback

    def _degrade(self, args: tuple, *, site: str, cause: str, original=None):
        """The sharded ladder: a failed collective schedule falls back to
        REPLICATED execution of the identical spec on this rank's global
        operands (the unsharded planner, same backend), so the numerics are
        kept at the cost of the collective's speedup."""
        if self._active == "replicated":  # already degraded once
            raise RuntimeError(
                f"sharded plan failed again after degrading to replicated ({cause})"
            ) from original
        self._record(site, cause, fallback="replicated", schedule=self.schedule,
                     backend=self.active_backend)
        fb = plan(dataclasses.replace(self.spec, shard=None), backend=self.backend,
                  device=self.device, fallback=True)
        out = fb._execute(args)
        self._fn = fb._fn
        self._active = "replicated"
        return out


@dataclasses.dataclass
class ShardedGroupedPlan(ShardedPlan):
    """A GroupedPlan over a device mesh: the `expert` schedule.

    The group (expert) dim shards over `ShardSpec.axis_g`: each rank takes
    its groups' token rows, sizes and weight slabs and runs the ordinary
    per-shard GroupedPlan over them (K5 on the card); the output rows stay
    group-sharded until they are assembled.  The epilogue shards with its
    operands (per-group bias, group-major residual), so it stays inside the
    local kernel, unlike the K-collective schedules.
    """

    _check_grouped_operands = GroupedPlan._check_grouped_operands
    __call__ = GroupedPlan.__call__
    dispatch = GroupedPlan.dispatch

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["fused_epilogue"] = self.capabilities.epilogue_fusion
        return d


_ALL = frozenset(STRUCTURES)
# The `torch` backend also runs on the meta device: shapes and dtypes, no
# values (the dry runs' trace, `launch/dryrun.py`).
register_backend(
    "torch",
    _dense_impl("torch"),
    BackendCapabilities(structures=frozenset({"general", "symmetric"}), batching=True,
                        devices=frozenset({"cpu", "cuda", "meta"}), sharding=True,
                        grouped=True),
    grouped_impl=_torch_grouped_impl,
)
register_backend(
    "cuda_mesh",
    _dense_impl("cuda_mesh"),
    BackendCapabilities(structures=_ALL, batching=True, epilogue_fusion=True, autotune=True,
                        sharding=True, grouped=True),
    grouped_impl=_cuda_mesh_grouped_impl,
)
register_backend(
    "ref",
    _dense_impl("ref"),
    BackendCapabilities(structures=_ALL, batching=True, sharding=True, grouped=True),
    grouped_impl=_ref_grouped_impl,
)


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------


def plan(
    spec: GemmSpec,
    *,
    backend: Optional[str] = None,
    device="cpu",
    mesh=None,
    guard_nonfinite: Optional[str] = None,
    guard_sample: Optional[int] = None,
    fallback: bool = False,
) -> Plan:
    """Validate `spec` against backend capabilities and return the cached,
    reusable executable for it on `device`'s type.

    Resolution happens once per (spec, backend, device type, guard,
    fallback): capability checks, block shapes, and the sigma table are
    fixed here, and repeated calls return the identical Plan.  An explicit
    `backend` is validated strictly (CapabilityError on mismatch); otherwise
    a capable pinned default wins, else the capable set ranked by the cost
    model (decision provenance in `describe()["decision"]`).  Spec-level
    problems raise PlanValidationError.

    A spec carrying a ShardSpec needs the device `mesh` and returns a
    ShardedPlan (a ShardedGroupedPlan for a grouped spec); `mesh=` without a
    ShardSpec auto-shards: the cost model picks the axes and the schedule
    over the mesh (`describe()["decision"]["sharding"]`).  Equal meshes key
    the same cache entry.  With `fallback=True` a sharded plan's failed
    collective degrades to replicated execution.

    With `fallback=True` a failed plan BUILD falls down the
    capability-ordered chain (`FALLBACK_ORDER`) to the next backend able to
    run the spec, recording a DegradationEvent in the plan's `health` and
    the global ledger; only when every capable backend fails does the last
    error surface.  The rest of the chain stays behind the plan for
    execution-time degradation.  With `fallback=False` (the port's default)
    a failed build or execution raises.  `guard_nonfinite` opts the plan
    into the post-epilogue NaN/Inf guard with policy `raise | fallback |
    zero_and_record` (`guard_sample` spot-checks that many strided output
    elements instead of reducing the whole output).
    """
    if not isinstance(spec, GemmSpec):
        raise TypeError(f"plan() takes a GemmSpec, got {type(spec).__name__}")
    if spec.shard is not None and mesh is None:
        raise ValueError("spec carries a ShardSpec; pass the device mesh: plan(spec, mesh=mesh)")
    dev = torch.device(device).type
    shard_decision = None
    if spec.shard is None and mesh is not None:
        spec, shard_decision = _auto_shard(spec, mesh, dev)
    if guard_nonfinite is not None:
        guard_nonfinite = normalize_policy(guard_nonfinite)
    decision = None
    if backend is not None:
        be = _require_backend(backend)
        reason = _check_capabilities(spec, be, dev)
        if reason is not None:
            raise CapabilityError(reason)
    else:
        be, decision = _choose_backend(spec, dev)

    key = (spec, be.name, dev, guard_nonfinite, guard_sample, bool(fallback), _mesh_key(mesh))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_STATS["hits"] += 1
        return cached
    _PLAN_STATS["misses"] += 1

    chain = _fallback_chain(spec, be, dev) if fallback else [be]
    build_events = []
    p = None
    built_at = 0
    with _obs.span(
        "plan.build",
        backend=be.name,
        structure=spec.structure,
        mkn=f"{spec.eff_m}x{spec.k}x{spec.n}",
        sharded=mesh is not None,
    ) as bsp:
        for i, cand in enumerate(chain):
            try:
                _faults.check("plan.build", backend=cand.name)
                p = (_build_plan(spec, cand, dev) if mesh is None
                     else _build_sharded_plan(spec, cand, mesh, dev))
                built_at = i
                break
            except (PlanValidationError, CapabilityError):
                raise
            except Exception as e:
                if i + 1 >= len(chain):
                    raise
                build_events.append(
                    _rledger.record(
                        "plan.build",
                        cause=f"{type(e).__name__}: {e}",
                        fallback=chain[i + 1].name,
                        backend=cand.name,
                    )
                )
        bsp.set("built_backend", chain[built_at].name)
        bsp.set("blocks", list(p.blocks) if p.blocks else None)
        if isinstance(p, ShardedPlan):
            bsp.set("schedule", p.schedule)
            p.fallback = bool(fallback)
    p.health.extend(build_events)
    if decision is not None or shard_decision is not None:
        # merged with the schedule decision _build_sharded_plan attached
        dec = dict(p.decision or {})
        if decision is not None:
            dec["backend"] = decision
        if shard_decision is not None:
            dec["sharding"] = shard_decision
        p.decision = dec
    # Backends still available below the one that built: the execution-time
    # degradation ladder (Plan._degrade).
    p._chain = [c.name for c in chain[built_at + 1:]]
    p.guard = guard_nonfinite
    p.guard_sample = guard_sample
    _PLAN_CACHE[key] = p
    return p


def _resolve_blocks_via_costmodel(
    m: int, k: int, n: int, dtype, backend: str, *, symmetry: int = 0,
    platform: str = "cpu",
) -> Tuple[int, int, int]:
    """Block resolution through the cost model's chooser: IDENTICAL to
    `autotune.resolve_blocks` (same cache, same ranking) until coefficients
    are CALIBRATED, when the candidate ranking switches to
    `costmodel.model.predict_blocks_ms`.  Any chooser failure degrades to
    the autotuner directly."""
    try:
        from repro_torch.costmodel import choose as _cm_choose

        blocks, _ = _cm_choose.choose_blocks(
            m, k, n, dtype, backend, symmetry=symmetry, platform=platform
        )
        return blocks
    except Exception:
        return _autotune.resolve_blocks(m, k, n, dtype, backend, symmetry=symmetry,
                                        platform=platform)


def _resolved_blocks(spec: GemmSpec, m: int, backend: str, device: str) -> Tuple[int, int, int]:
    """`spec.blocks` with its None entries resolved for an m-row product."""
    partial = spec.blocks or (None, None, None)
    if None not in partial:
        return partial
    symmetry = 1 if spec.structure == "symmetric" else 0
    resolved = _resolve_blocks_via_costmodel(
        m, spec.k, spec.n, spec.acc_dtype, backend, symmetry=symmetry, platform=device
    )
    return tuple(p or r for p, r in zip(partial, resolved))


def _plan_vmem_bytes(spec: GemmSpec, m: int, blocks, device: str, *,
                     grouped: bool = False) -> int:
    """The working set of `blocks` in the reference's model on the CPU; on
    the card the shared memory of the tile that runs the product."""
    if device == "cuda":
        return _autotune.tile_smem_bytes(m, spec.k, spec.n, blocks, spec.acc_dtype,
                                         grouped=grouped)
    return _autotune.vmem_bytes(*blocks, spec.acc_dtype, has_bias=spec.epilogue.bias,
                                has_residual=spec.epilogue.residual)


def _grouped_block_m(rpg: int, bm: int) -> int:
    """Largest block_m that both divides rows_per_group and respects the
    chosen bm — the (g, i, j, k) grid needs whole row blocks per group."""
    if rpg % bm == 0:
        return bm
    g = math.gcd(rpg, bm)
    return g if g >= 8 else rpg


def _build_grouped_plan(spec: GemmSpec, be: _Backend, device: str) -> GroupedPlan:
    """Grouped planning: resolve the blocks ONCE per logical group shape
    (m = the rows-per-group bound), then clamp block_m to divide it."""
    rpg = spec.group.rows_per_group
    blocks = vmem = None
    if be.caps.autotune:
        bm, bn, bk = _resolved_blocks(spec, rpg, be.name, device)
        blocks = (_grouped_block_m(rpg, bm), bn, bk)
        vmem = _plan_vmem_bytes(spec, rpg, blocks, device, grouped=True)
    p = GroupedPlan(
        spec=spec,
        backend=be.name,
        capabilities=be.caps,
        device=device,
        blocks=blocks,
        out_dtype=spec.resolved_out_dtype(),
        flops=spec.flops(),
        vmem_bytes=vmem,
    )
    impl = be.grouped_impl
    p._fn = lambda t, off, w, bias, residual: impl(p, t, off, w, bias, residual)
    return p


def _build_plan(spec: GemmSpec, be: _Backend, device: str) -> Plan:
    if spec.group is not None:
        return _build_grouped_plan(spec, be, device)
    blocks = vmem = None
    if be.caps.autotune or spec.structure == "scrambled":
        # The scrambled σ-table constraint keys its own cache partition.
        tune_backend = "cuda_mesh_scrambled" if spec.structure == "scrambled" else be.name
        blocks = _resolved_blocks(spec, spec.eff_m, tune_backend, device)
        vmem = _plan_vmem_bytes(spec, spec.eff_m, blocks, device)
    if spec.structure == "symmetric" and spec.m != spec.n:
        raise PlanValidationError(
            f"structure='symmetric' requires a square product, got {spec.m}x{spec.n}"
        )
    sigma = None
    if spec.structure == "scrambled":
        bm, bn, _ = blocks
        eff_m, n = spec.eff_m, spec.n
        if eff_m % bm or n % bn:
            raise PlanValidationError(
                "structure='scrambled' requires block-aligned M and N "
                f"(got M={eff_m}, N={n} with blocks {bm}x{bn})"
            )
        if eff_m // bm != n // bn:
            raise PlanValidationError(
                f"scramble_out needs square block grid, got {eff_m // bm}x{n // bn}"
            )
        sigma = sigma_block_table(eff_m // bm)
    p = Plan(
        spec=spec,
        backend=be.name,
        capabilities=be.caps,
        device=device,
        blocks=blocks,
        out_dtype=spec.resolved_out_dtype(),
        flops=spec.flops(),
        vmem_bytes=vmem,
        sigma_table=sigma,
    )
    impl = be.impl
    p._fn = lambda a, b, bias, residual: impl(p, a, b, bias, residual)
    return p


# ---------------------------------------------------------------------------
# Sharded planning
# ---------------------------------------------------------------------------


def _mesh_key(mesh):
    """The plan-cache key of a mesh: its layout, and the ranks of a
    DeviceMesh (equal meshes share plans, meshes over other ranks don't)."""
    if mesh is None:
        return None
    ranks = getattr(mesh, "mesh", None)
    return (tuple(mesh_shape(mesh).items()),
            None if ranks is None else tuple(int(r) for r in ranks.flatten().tolist()))


def _legacy_auto_schedule(spec: GemmSpec) -> str:
    """The divisibility heuristic: the degraded fallback AND the shape of
    the cost model's tie-breaks: a K partition rings (scatter when M
    divides it), anything else replicates."""
    shard = spec.shard
    pk = shard.axis_size(shard.axis_k)
    if pk > 1:
        return "reduce_scatter_k" if spec.eff_m % pk == 0 else "ring_k"
    return "replicated"


def _auto_schedule(spec: GemmSpec, platform: str) -> Tuple[str, Optional[Dict[str, Any]]]:
    """Resolve schedule='auto' through the cost model on `platform`.  The
    model legality-trials every schedule with this module's own validation,
    so it never picks an illegal one; with no legal candidate the legacy
    heuristic names the schedule whose validation raises the precise error,
    and any other cost-model failure degrades to the legacy choice with a
    ledger record."""
    from repro_torch.costmodel import choose as _cm_choose

    try:
        sched, dec = _cm_choose.decide_schedule(spec, platform=platform)
        return sched, dec.as_dict()
    except _cm_choose.NoLegalCandidate:
        return _legacy_auto_schedule(spec), None
    except Exception as e:
        _rledger.record("costmodel.decide_schedule", cause=f"{type(e).__name__}: {e}",
                        fallback="legacy-heuristic")
        return _legacy_auto_schedule(spec), None


def _auto_shard(spec: GemmSpec, mesh, platform: str) -> Tuple[GemmSpec, Optional[Dict[str, Any]]]:
    """plan(spec, mesh=...) with NO ShardSpec: the cost model picks the axes
    AND the schedule over the mesh.  The degraded fallback is the unsharded
    ShardSpec (correct on any mesh), with a ledger record."""
    try:
        from repro_torch.costmodel import choose as _cm_choose

        shard, dec = _cm_choose.decide_sharding(spec, mesh, platform=platform)
        return dataclasses.replace(spec, shard=shard), dec.as_dict()
    except Exception as e:
        _rledger.record("costmodel.decide_sharding", cause=f"{type(e).__name__}: {e}",
                        fallback="unsharded")
        return dataclasses.replace(spec, shard=ShardSpec.unsharded(mesh)), None


def _resolve_sharding(
    spec: GemmSpec, platform: str = "cpu",
) -> Tuple[str, GemmSpec, int, int, Optional[Dict[str, Any]]]:
    """Choose/validate the collective schedule of `spec.shard` and derive
    (schedule, per-shard local spec, bytes moved per rank per call,
    collective phase count, cost-model decision provenance: None unless
    schedule='auto' resolved through the model on `platform`).

    The local spec is the same GemmSpec type the unsharded planner takes:
    epilogue stripped (applied after the collective), output f32, structure
    'general' (per-shard tiles are rectangular).
    """
    shard = spec.shard
    if spec.group is not None:
        return _resolve_grouped_sharding(spec)
    if shard.axis_g is not None:
        raise PlanValidationError(
            "axis_g partitions the group dim of a GROUPED spec; this spec carries no GroupSpec"
        )
    if spec.structure == "scrambled":
        raise PlanValidationError(
            "structure='scrambled' does not compose with a ShardSpec: the σ arrangement is"
            " defined on the global block grid"
        )
    if spec.structure == "symmetric" and spec.m != spec.n:
        raise PlanValidationError(
            f"structure='symmetric' requires a square product, got {spec.m}x{spec.n}"
        )
    pm = shard.axis_size(shard.axis_m)
    pk = shard.axis_size(shard.axis_k)
    pn = shard.axis_size(shard.axis_n)
    pb = shard.axis_size(shard.axis_batch)
    eff_m = spec.eff_m

    sched = shard.schedule
    decision = None
    if sched == "auto":
        sched, decision = _auto_schedule(spec, platform)
    if sched == "expert":
        raise PlanValidationError(
            "schedule 'expert' shards the group dim of a GROUPED spec; this spec carries no"
            " GroupSpec"
        )

    def div(what: str, dim: int, axes, p: int) -> int:
        if dim % p:
            raise PlanValidationError(
                f"{what}={dim} is not divisible by mesh axes {axes!r} (size {p}) required by"
                f" schedule {sched!r} on mesh {shard.mesh_axes}"
            )
        return dim // p

    if spec.batched_b and sched != "replicated":
        raise PlanValidationError(
            f"schedule {sched!r} does not support fully-batched operands; use the replicated"
            " schedule (batch/M/N partitions are local)"
        )
    if shard.axis_batch is not None and not spec.batch:
        raise PlanValidationError("axis_batch given but the spec has no batch dims")
    if not spec.batched_b and pb > 1:
        raise PlanValidationError(
            "axis_batch partitions the leading dim of a fully-batched product; with 2D b the"
            " batch folds into M — shard axis_m instead"
        )

    lb: Tuple[int, ...] = spec.batch
    if sched == "replicated":
        if pk > 1:
            raise PlanValidationError(
                "schedule 'replicated' cannot shard K (a K partition needs a collective; use"
                " 'reduce_scatter_k' or 'ring_k')"
            )
        if spec.batched_b:
            lb = (div("batch", math.prod(spec.batch), shard.axis_batch, pb),)
            lm = div("M", spec.m, shard.axis_m, pm)
        else:
            lm = div("M", eff_m, shard.axis_m, pm)
        lk, ln = spec.k, div("N", spec.n, shard.axis_n, pn)
        bytes_moved, phases = 0, 0
    elif sched in ("allgather_a", "allgather_a_overlap"):
        if not isinstance(shard.axis_m, str):
            raise PlanValidationError(
                f"schedule {sched!r} needs a single mesh axis on M (axis_m={shard.axis_m!r})"
                " — the gather is a 1D ring"
            )
        if pk > 1 or pn > 1:
            raise PlanValidationError(f"schedule {sched!r} shards only M; drop axis_k/axis_n")
        lm = div("M", eff_m, shard.axis_m, pm)
        lk, ln = spec.k, spec.n
        if sched == "allgather_a_overlap":
            if pm < 2:
                raise PlanValidationError(
                    "schedule 'allgather_a_overlap' double-buffers a ring of size >= 2;"
                    f" axis_m={shard.axis_m!r} has size {pm}"
                )
            if spec.n < 2 or spec.n % 2:
                raise PlanValidationError(
                    "schedule 'allgather_a_overlap' splits the local product into two column"
                    f" halves; N={spec.n} must be even"
                )
            ln = spec.n // 2  # per-shard plan built at the half width
        # Each rank computes its (lm, n) result chunk ONCE; the f32 chunks
        # hop the ring pm-1 times.
        bytes_moved = (pm - 1) * lm * spec.n * 4
        phases = pm - 1
    elif sched in ("reduce_scatter_k", "reduce_scatter_k_overlap", "ring_k", "ring_k_overlap",
                   "pipeline"):
        if shard.axis_k is None:
            raise PlanValidationError(f"schedule {sched!r} requires axis_k")
        if pm > 1 or pn > 1:
            if shard.schedule == "auto":
                raise PlanValidationError(
                    "no collective schedule combines a K partition with an M/N partition;"
                    " shard K alone (reduce_scatter_k / ring_k) or drop axis_k"
                )
            raise PlanValidationError(f"schedule {sched!r} shards only K; drop axis_m/axis_n")
        lk = div("K", spec.k, shard.axis_k, pk)
        ln = spec.n
        if sched in ("reduce_scatter_k", "reduce_scatter_k_overlap"):
            lm = div("M", eff_m, shard.axis_k, pk)
            # f32 accumulator row-chunks hop the ring p-1 times
            bytes_moved = (pk - 1) * lm * spec.n * 4
            phases = pk - 1
        elif sched == "pipeline":
            mb = div("M", eff_m, shard.axis_k, pk)
            micro = _pipeline_microbatches(eff_m, pk)
            lm = eff_m // micro  # one microbatch chain per product
            # reduce_scatter_k's accumulator bytes, split over micro/pk
            # chains of (pk-1) hops each
            bytes_moved = (pk - 1) * mb * spec.n * 4
            phases = micro - micro // pk
        else:  # ring_k / ring_k_overlap
            lm = eff_m
            if sched == "ring_k_overlap":
                if pk < 2:
                    raise PlanValidationError(
                        "schedule 'ring_k_overlap' double-buffers a ring of size >= 2;"
                        f" axis_k={shard.axis_k!r} has size {pk}"
                    )
                if spec.n < 2 or spec.n % 2:
                    raise PlanValidationError(
                        "schedule 'ring_k_overlap' splits the partial into two column halves;"
                        f" N={spec.n} must be even"
                    )
                ln = spec.n // 2  # per-shard plan built at the half width
            # full f32 accumulator wavefronts hop the ring p-1 times
            bytes_moved = (pk - 1) * eff_m * spec.n * 4
            phases = pk - 1
    else:  # pragma: no cover — ShardSpec.__post_init__ rejects unknown names
        raise PlanValidationError(f"unknown schedule {sched!r}")

    local = dataclasses.replace(
        spec, m=lm, k=lk, n=ln, batch=lb if spec.batched_b else (), batched_b=spec.batched_b,
        structure="general", epilogue=Epilogue(), out_dtype="float32", shard=None,
    )
    return sched, local, bytes_moved, phases, decision


def _resolve_grouped_sharding(
    spec: GemmSpec,
) -> Tuple[str, GemmSpec, int, int, Optional[Dict[str, Any]]]:
    """The grouped analogue of `_resolve_sharding`: the one partition is the
    group (expert) dim over `axis_g`, the `expert` schedule.  bytes_moved
    reports the boundary resharding of the token rows (the EP all-to-all a
    data-sharded caller pays)."""
    shard = spec.shard
    grp = spec.group
    for field in ("axis_m", "axis_k", "axis_n", "axis_batch"):
        if getattr(shard, field) is not None and shard.axis_size(getattr(shard, field)) > 1:
            raise PlanValidationError(
                f"grouped specs shard only the group dim (axis_g); drop {field}"
            )
    pg = shard.axis_size(shard.axis_g)
    sched = shard.schedule
    if sched == "auto":
        sched = "expert" if pg > 1 else "replicated"
    if sched not in ("expert", "replicated"):
        raise PlanValidationError(
            f"schedule {sched!r} does not apply to grouped specs; use 'expert' (group dim"
            " over axis_g) or 'replicated'"
        )
    if sched == "replicated" and pg > 1:
        raise PlanValidationError("schedule 'replicated' cannot shard the group dim; use 'expert'")
    if grp.num_groups % pg:
        raise PlanValidationError(
            f"num_groups={grp.num_groups} is not divisible by mesh axis {shard.axis_g!r}"
            f" (size {pg}) required by schedule 'expert' on mesh {shard.mesh_axes}"
        )
    local_grp = GroupSpec(grp.num_groups // pg, grp.rows_per_group)
    local = dataclasses.replace(spec, m=local_grp.rows, group=local_grp, shard=None)
    if pg > 1:
        ia = _NAME_DTYPES[spec.dtype_a].itemsize
        io = _NAME_DTYPES[spec.resolved_out_dtype()].itemsize
        # (p-1)/p of the token rows change rank on the way in, and again out
        bytes_moved = (pg - 1) * grp.rows * (spec.k * ia + spec.n * io) // pg
        phases = pg - 1
    else:
        bytes_moved, phases = 0, 0
    return ("expert" if pg > 1 else "replicated"), local, bytes_moved, phases, None


def _grouped_sharded_executor(spec: GemmSpec, sched: str, mesh, local_plan: Plan) -> Callable:
    """SPMD executor of grouped specs: each rank runs the local GroupedPlan
    over its groups' rows, sizes and weights; the group-sharded output rows
    are assembled on every rank."""
    from repro_torch.parallel.collectives import assemble, local_shard
    from repro_torch.parallel.sharding import PartitionSpec as P
    from repro_torch.parallel.sharding import mesh_layout

    ag = spec.shard.axis_g if sched == "expert" else None

    def run(tokens, group_offsets, weights, bias, residual):
        lay = mesh_layout(mesh)
        sizes = local_shard(_grouped_sizes(group_offsets), P(ag), lay)
        off = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0).to(torch.int32)])
        out = local_plan._fn(
            local_shard(tokens, P(ag, None), lay), off,
            local_shard(weights, P(ag, None, None), lay),
            None if bias is None else local_shard(bias, P(ag, None), lay),
            None if residual is None else local_shard(residual, P(ag, None), lay))
        return assemble(out, P(ag, None), lay)

    return run


def _sharded_executor(spec: GemmSpec, sched: str, mesh, local_plan: Plan) -> Callable:
    """The global-operand executor: each rank slices its shards (the
    reference's shard_map in_specs), runs the collective around the
    per-shard product and the epilogue, and the result is assembled from the
    ranks' blocks (its out_spec), with batch folding around it."""
    from repro_torch.parallel.collectives import (
        assemble,
        local_shard,
        matmul_ring_reducescatter,
        ring_allgather_matmul,
        ring_pipeline_matmul,
    )
    from repro_torch.parallel.sharding import PartitionSpec as P
    from repro_torch.parallel.sharding import mesh_layout
    from repro_torch.parallel.systolic import ring_systolic_kpass

    shard = spec.shard
    epi = spec.epilogue
    act = epi.activation
    out_dt = _NAME_DTYPES[spec.resolved_out_dtype()]
    am, ak, an, ab = shard.axis_m, shard.axis_k, shard.axis_n, shard.axis_batch
    overlap = sched.endswith("_overlap")
    base = sched[: -len("_overlap")] if overlap else sched

    def local_mm(x, y):
        return local_plan._fn(x, y, None, None)

    if spec.batched_b:  # replicated schedule only (validated upstream)
        in_a, in_b, in_bias, in_res = P(ab, am, None), P(ab, None, an), P(an), P(ab, am, an)
        out_spec = P(ab, am, an)
    elif sched == "replicated":
        in_a, in_b, in_bias, in_res = P(am, None), P(None, an), P(an), P(am, an)
        out_spec = P(am, an)
    elif base == "allgather_a":
        in_a, in_b, in_bias, in_res = P(am, None), P(), P(), P()
        out_spec = P()
    elif base in ("reduce_scatter_k", "pipeline"):
        in_a, in_b, in_bias = P(None, ak), P(ak, None), P()
        in_res = out_spec = P(ak, None)
    else:  # ring_k / ring_k_overlap
        in_a, in_b, in_bias, in_res = P(None, ak), P(ak, None), P(), P()
        out_spec = P()
    micro = _pipeline_microbatches(spec.eff_m, shard.axis_size(ak)) if sched == "pipeline" else 0

    def body(a_blk, b_blk, bias_blk, res_blk):
        if sched == "replicated":
            z = local_plan._fn(a_blk, b_blk, None, None)
        elif base == "allgather_a":
            z = ring_allgather_matmul(a_blk, b_blk, am, mesh=mesh, matmul=local_mm,
                                      overlap=overlap)
        elif base == "reduce_scatter_k":
            z = matmul_ring_reducescatter(a_blk, b_blk, ak, mesh=mesh, matmul=local_mm,
                                          overlap=overlap)
        elif sched == "pipeline":
            z = ring_pipeline_matmul(a_blk, b_blk, ak, mesh=mesh, microbatches=micro,
                                     matmul=local_mm)
        else:
            z = ring_systolic_kpass(a_blk, b_blk, axis=ak, mesh=mesh, matmul=local_mm,
                                    overlap=overlap)
        return apply_epilogue(z, bias_blk, act, res_blk).to(out_dt)

    eff_m = spec.eff_m

    def run(a, b, bias, residual):
        lay = mesh_layout(mesh)
        if spec.batched_b:
            nb = math.prod(spec.batch)
            af, bf = a.reshape(nb, spec.m, spec.k), b.reshape(nb, spec.k, spec.n)
            resf = None if residual is None else residual.reshape(nb, spec.m, spec.n)
        else:
            # Leading batch dims of `a` fold into M: the M partition shards eff_m.
            af, bf = a.reshape(eff_m, spec.k), b
            resf = None if residual is None else residual.reshape(eff_m, spec.n)
        z = body(local_shard(af, in_a, lay), local_shard(bf, in_b, lay),
                 None if bias is None else local_shard(bias, in_bias, lay),
                 None if resf is None else local_shard(resf, in_res, lay))
        out = assemble(z, out_spec, lay)
        return out.reshape(*spec.batch, spec.m, spec.n) if spec.batch else out

    return run


def _build_sharded_plan(spec: GemmSpec, be: _Backend, mesh, device: str) -> ShardedPlan:
    """ONE planner: resolve the collective schedule, build the per-shard
    Plan through the ordinary `plan()` path (cached, blocks resolved at the
    LOCAL shape) and wrap it in the SPMD executor."""
    shard = spec.shard
    live = tuple(mesh_shape(mesh).items())
    if live != shard.mesh_axes:
        raise PlanValidationError(
            f"ShardSpec was built for mesh axes {shard.mesh_axes} but plan() got a mesh with"
            f" {live}; rebuild it with ShardSpec.from_mesh(mesh, ...)"
        )
    sched, local_spec, bytes_moved, phases, sched_decision = _resolve_sharding(spec, device)
    local_plan = plan(local_spec, backend=be.name, device=device)
    if sched in ("reduce_scatter_k", "reduce_scatter_k_overlap"):
        invocations = phases + 1
    elif sched == "pipeline":
        invocations = _pipeline_microbatches(spec.eff_m, shard.axis_size(shard.axis_k))
    elif sched in ("allgather_a_overlap", "ring_k_overlap"):
        invocations = 2
    else:
        invocations = 1
    cls = ShardedGroupedPlan if spec.group is not None else ShardedPlan
    p = cls(
        spec=spec,
        backend=be.name,
        capabilities=be.caps,
        device=device,
        blocks=local_plan.blocks,
        out_dtype=spec.resolved_out_dtype(),
        flops=spec.flops(),
        vmem_bytes=local_plan.vmem_bytes,
        mesh=mesh,
        schedule=sched,
        local=local_plan,
        bytes_moved=bytes_moved,
        collective_phases=phases,
        kernel_invocations=invocations,
    )
    if sched_decision is not None:
        p.decision = {"schedule": sched_decision}
    executor = _grouped_sharded_executor if spec.group is not None else _sharded_executor
    p._fn = executor(spec, sched, mesh, local_plan)
    return p


def execute_async(items) -> List[torch.Tensor]:
    """Dispatch independent plan executions back to back, sync ONCE at the end.

    `items` is an iterable of `(plan, args)` pairs, `args` the positional
    operand tuple for that plan (`(a, b)`, optionally with bias/residual).
    Every execution is enqueued before anything waits; then the last
    handle of each device is waited on (one stream, so it covers the rest),
    and the outputs return in input order.
    """
    handles = [p.dispatch(*args) for p, args in items]
    last = {}
    for h in handles:
        last[h.out.device] = h
    for h in last.values():
        h.block()
    return [h.out for h in handles]


def clear_plan_cache(device: Optional[str] = None) -> None:
    """Test hook: drop all cached plans and reset the hit/miss counters;
    with `device` (a device type), drop only the plans for that device and
    keep the counters (the dry runs drop their meta-device plans)."""
    if device is not None:
        for key in [k for k in _PLAN_CACHE if k[2] == device]:
            del _PLAN_CACHE[key]
        return
    _PLAN_CACHE.clear()
    _PLAN_STATS.update(hits=0, misses=0)


def plan_cache_info() -> Dict[str, Any]:
    """Cache telemetry: one entry per (spec, backend, device type, guard,
    fallback, mesh) planned."""
    return {
        "size": len(_PLAN_CACHE),
        "hits": _PLAN_STATS["hits"],
        "misses": _PLAN_STATS["misses"],
        "plans": [p.describe() for p in _PLAN_CACHE.values()],
    }
