"""Plan/execute operator API: typed GEMM specs + capability-based backends.

Port of `repro.kernels.api`, trimmed to what the dense serving path runs.
Planning — resolve a backend against declared capabilities, fix the block
shapes, precompute the sigma table — is separated from execution,
a cached reusable callable that serving invokes per request:

    spec = GemmSpec.from_operands(a, b, epilogue=Epilogue(bias=True,
                                                          activation="gelu"))
    p = plan(spec, backend="cuda_mesh")   # validate + build, ONCE
    y = p(a, b, bias=bias)                # reuse; p is cached per spec

Backends:
  torch      plain f32-accumulating matmul + unfused epilogue (the
             reference's `xla`)
  ref        the same plus the sigma scramble done as a gather (the oracle)
  cuda_mesh  the mesh kernel K1 (`kernels/mesh_matmul.py`) — the reference's
             `pallas_mesh`: launched on CUDA tensors, its plain version on
             CPU tensors the way `pallas_mesh` runs interpret mode off-TPU

Blocks come from `spec.blocks` when set, else (128, 128, 128); the
autotuner arrives in a later slice.  There is no fallback chain yet: a
`cuda_mesh` plan whose kernel fails to build or launch raises.

Gradients.  A `cuda_mesh` GEMM runs through `_MeshMM`, a
`torch.autograd.Function` on both devices, whose backward is the
reference's `_mm` VJP op for op (`mm_backward`): unscramble the cotangent,
recompute the pre-activation z with one plain f32 kernel call where there is
an activation, then dA = dz·Bᵀ and dB = Aᵀ·dz as two more f32 kernel GEMMs.
The `torch` and `ref` backends are plain ops that autograd differentiates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.mesh_matmul import (
    ACTIVATIONS,
    GELU_A,
    GELU_C,
    mesh_matmul,
    sigma_block_table,
)
from repro_torch.kernels.scramble import scramble_blocks

__all__ = [
    "DEFAULT_BLOCKS",
    "STRUCTURES",
    "BackendCapabilities",
    "CapabilityError",
    "Epilogue",
    "GemmSpec",
    "MMOpts",
    "Plan",
    "PlanValidationError",
    "apply_epilogue",
    "backend_names",
    "clear_plan_cache",
    "mm_backward",
    "plan",
    "plan_cache_info",
    "register_backend",
    "unregister_backend",
]

STRUCTURES = ("general", "symmetric", "scrambled")
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
class GemmSpec:
    """Logical description of one GEMM: (batch..., M, K) @ (K, N) — or, when
    `batched_b`, (batch..., M, K) @ (batch..., K, N).

    `structure` names the paper regime of the product: general (C = AB),
    symmetric (caller asserts C = Cᵀ; square), scrambled (the output lands in
    the paper's sigma block arrangement).  `blocks` is an optional
    (bm, bn, bk) override; entries left None take DEFAULT_BLOCKS.  `repeats`
    is a caller hint (products run back to back with the same B); numerics
    are unaffected.  Hashable and frozen — specs are the plan-cache key.
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
    repeats: int = 1

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(
                f"structure must be one of {STRUCTURES}, got {self.structure!r}"
            )
        if min(self.m, self.k, self.n) <= 0:
            raise ValueError(f"dims must be positive, got {(self.m, self.k, self.n)}")
        if self.batched_b and not self.batch:
            raise ValueError("batched_b requires leading batch dims")
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
    devices           device types the impl executes on
    """

    structures: FrozenSet[str] = frozenset({"general"})
    batching: bool = False
    epilogue: bool = True
    epilogue_fusion: bool = False
    devices: FrozenSet[str] = frozenset({"cpu", "cuda"})

    def __post_init__(self):
        object.__setattr__(self, "structures", frozenset(self.structures))
        object.__setattr__(self, "devices", frozenset(self.devices))
        unknown = self.structures - set(STRUCTURES)
        if unknown:
            raise ValueError(f"unknown structures {sorted(unknown)}; known: {STRUCTURES}")


_CAP_FIELDS = {f.name for f in dataclasses.fields(BackendCapabilities)}

# impl(plan, a, b, bias, residual) -> tensor
BackendImpl = Callable[["Plan", torch.Tensor, torch.Tensor, Any, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class _Backend:
    name: str
    impl: BackendImpl
    caps: BackendCapabilities


_REGISTRY: Dict[str, _Backend] = {}

# Plan cache: one entry per (spec, backend, device type) ever planned
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
    override: bool = False,
) -> None:
    """Register a GEMM backend under `name` with declared capabilities.

    `capabilities` is a BackendCapabilities or a mapping with only its field
    names — unknown keys are rejected so typos never grant an ability.
    Duplicate names are rejected unless `override=True`.
    """
    if not isinstance(capabilities, BackendCapabilities):
        unknown = set(capabilities) - _CAP_FIELDS
        if unknown:
            raise ValueError(
                f"unknown capabilities {sorted(unknown)}; known: {sorted(_CAP_FIELDS)}"
            )
        capabilities = BackendCapabilities(**capabilities)
    if name in _REGISTRY and not override:
        raise ValueError(f"backend {name!r} already registered (pass override=True to replace)")
    _REGISTRY[name] = _Backend(name, impl, capabilities)
    _evict_plans(name)


def unregister_backend(name: str) -> None:
    if _REGISTRY.pop(name, None) is not None:
        _evict_plans(name)


def backend_names() -> List[str]:
    return list(_REGISTRY)


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
    return None


def _choose_backend(spec: GemmSpec, device: str) -> _Backend:
    """First capable backend in the reference's legacy order: torch (the
    `xla` stand-in), then cuda_mesh, then registration order."""
    reasons = []
    for name in dict.fromkeys(("torch", "cuda_mesh", *_REGISTRY)):
        be = _REGISTRY.get(name)
        if be is None:
            continue
        reason = _check_capabilities(spec, be, device)
        if reason is None:
            return be
        reasons.append(reason)
    raise CapabilityError("no registered backend can execute this spec: " + "; ".join(reasons))


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


@dataclasses.dataclass
class Plan:
    """A resolved, reusable GEMM executable with provenance.

    Built once by `plan(spec)`; calling it runs the chosen backend with the
    blocks/tables fixed at plan time.  `device` is the device type the plan
    was built for; the sigma table is uploaded to a device once, on the
    plan's first call there.
    """

    spec: GemmSpec
    backend: str
    capabilities: BackendCapabilities
    device: str
    blocks: Optional[Tuple[int, int, int]]
    out_dtype: str
    flops: int
    sigma_table: Optional[np.ndarray] = None
    _fn: Optional[Callable] = dataclasses.field(default=None, repr=False)
    _sigma_dev: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def activation(self) -> Optional[str]:
        return self.spec.epilogue.activation

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
        """JSON-able provenance record (serving telemetry)."""
        return {
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
        }

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
        if bias is not None and tuple(bias.shape) != (spec.n,):
            raise ValueError(f"bias must have shape ({spec.n},), got {tuple(bias.shape)}")
        want_res = spec.batch + (spec.m, spec.n)
        if residual is not None and tuple(residual.shape) != want_res:
            raise ValueError(f"residual must have shape {want_res}, got {tuple(residual.shape)}")

    def __call__(self, a, b, bias=None, residual=None) -> torch.Tensor:
        self._check_operands(a, b, bias, residual)
        return self._fn(a, b, bias, residual)


def _torch_impl(p: Plan, a, b, bias, residual):
    z = torch.matmul(a.float(), b.float())
    return apply_epilogue(z, bias, p.activation, residual).to(_NAME_DTYPES[p.out_dtype])


def _ref_impl(p: Plan, a, b, bias, residual):
    """Plain-torch oracle backend: same contract, no kernel — registered
    through the same capability door as the real kernel."""
    y = apply_epilogue(torch.matmul(a.float(), b.float()), bias, p.activation, residual)
    if p.spec.structure == "scrambled":
        bm, bn, _ = p.blocks
        y = ref.scramble_blocks_ref(y, block_m=bm, block_n=bn)
    return y.to(_NAME_DTYPES[p.out_dtype])


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
    """The static options of one mesh GEMM (the reference's `_mm` opts)."""

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


class _MeshMM(torch.autograd.Function):
    """K1 forward with the reference's `_mm` VJP as its backward."""

    @staticmethod
    def forward(ctx, a2, b2, bias, residual, opts: MMOpts, sigma):
        ctx.opts = opts
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(a2, b2, bias)
        return mesh_matmul(
            a2, b2, bias=bias, residual=residual, block_m=opts.block_m,
            block_n=opts.block_n, block_k=opts.block_k, stagger=opts.stagger,
            scramble_out=opts.scramble, activation=opts.activation,
            out_dtype=opts.out_dtype, sigma=sigma,
        )

    @staticmethod
    def backward(ctx, g):
        a2, b2, bias = ctx.saved_tensors
        grads = mm_backward(g, a2, b2, bias, ctx.res_dtype, ctx.opts)
        return (*grads, None, None)


def _cuda_mesh_impl(p: Plan, a, b, bias, residual):
    """K1: 2D, batch-folded 2D, or fully batched (one launch, blockIdx.z),
    differentiable through `_MeshMM`."""
    spec = p.spec
    bm, bn, bk = p.blocks
    opts = MMOpts(bm, bn, bk, spec.stagger, spec.structure == "scrambled",
                  _NAME_DTYPES[p.out_dtype], p.activation)
    sigma = p.sigma_on(a.device)
    if not spec.batch:
        return _MeshMM.apply(a, b, bias, residual, opts, sigma)
    if not spec.batched_b:
        # Fold leading batch dims of `a` into M — still one 2D kernel.
        a2 = a.reshape(-1, spec.k)
        res2 = None if residual is None else residual.reshape(-1, spec.n)
        out = _MeshMM.apply(a2, b, bias, res2, opts, sigma)
        return out.reshape(*spec.batch, spec.m, spec.n)
    af = a.reshape(-1, spec.m, spec.k)
    bf = b.reshape(-1, spec.k, spec.n)
    resf = None if residual is None else residual.reshape(-1, spec.m, spec.n)
    out = _MeshMM.apply(af, bf, bias, resf, opts, sigma)
    return out.reshape(*spec.batch, spec.m, spec.n)


_ALL = frozenset(STRUCTURES)
register_backend(
    "torch",
    _torch_impl,
    BackendCapabilities(structures=frozenset({"general", "symmetric"}), batching=True),
)
register_backend(
    "cuda_mesh",
    _cuda_mesh_impl,
    BackendCapabilities(structures=_ALL, batching=True, epilogue_fusion=True),
)
register_backend("ref", _ref_impl, BackendCapabilities(structures=_ALL, batching=True))


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------


def plan(spec: GemmSpec, *, backend: Optional[str] = None, device="cpu") -> Plan:
    """Validate `spec` against backend capabilities and return the cached,
    reusable executable for it on `device`'s type.

    Resolution happens once per (spec, backend, device type): capability
    checks, block shapes, and the sigma table are fixed here, and
    repeated calls return the identical Plan.  An explicit `backend` is
    validated strictly (CapabilityError on mismatch); otherwise the first
    capable backend is chosen.  Spec-level problems raise
    PlanValidationError.
    """
    if not isinstance(spec, GemmSpec):
        raise TypeError(f"plan() takes a GemmSpec, got {type(spec).__name__}")
    dev = torch.device(device).type
    if backend is not None:
        be = _require_backend(backend)
        reason = _check_capabilities(spec, be, dev)
        if reason is not None:
            raise CapabilityError(reason)
    else:
        be = _choose_backend(spec, dev)

    key = (spec, be.name, dev)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_STATS["hits"] += 1
        return cached
    _PLAN_STATS["misses"] += 1
    p = _build_plan(spec, be, dev)
    _PLAN_CACHE[key] = p
    return p


def _build_plan(spec: GemmSpec, be: _Backend, device: str) -> Plan:
    blocks = None
    if be.name == "cuda_mesh" or spec.structure == "scrambled":
        partial = spec.blocks or (None, None, None)
        blocks = tuple(p or d for p, d in zip(partial, DEFAULT_BLOCKS))
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
        sigma_table=sigma,
    )
    impl = be.impl
    p._fn = lambda a, b, bias, residual: impl(p, a, b, bias, residual)
    return p


def clear_plan_cache() -> None:
    """Test hook: drop all cached plans and reset the hit/miss counters."""
    _PLAN_CACHE.clear()
    _PLAN_STATS.update(hits=0, misses=0)


def plan_cache_info() -> Dict[str, Any]:
    """Cache telemetry: one entry per (spec, backend, device type) planned."""
    return {
        "size": len(_PLAN_CACHE),
        "hits": _PLAN_STATS["hits"],
        "misses": _PLAN_STATS["misses"],
        "plans": [p.describe() for p in _PLAN_CACHE.values()],
    }
