"""Legacy GEMM entry points and the differentiable block scramble (port of
`repro.kernels.ops`).

The real dispatch layer is the plan/execute API:

    from repro_torch.kernels import api
    spec = api.GemmSpec.from_operands(a, b, epilogue=api.Epilogue(bias=True))
    p = api.plan(spec, device=a.device)   # capability-validated, cached
    y = p(a, b, bias=bias)

`matmul` here is a thin compat shim over it: string `backend=` selection
(including the alias `cuda_mesh_scrambled`, which is `structure="scrambled"`
on `cuda_mesh`) and the mutable process-global `set_default_backend` still
work, each emitting a DeprecationWarning once per process.  New code builds
a `GemmSpec`, or uses the scoped `api.default_backend(...)`.

`scramble_blocks` applies S^k at block granularity through K3
(`kernels/scramble.py`) with a gradient: the permutation's linearization is
itself and its transpose is the inverse permutation, so the backward pass is
S^-k of the cotangent — the reference's `_scramble_pallas_vjp`.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.kernels import api
from repro_torch.kernels import scramble as _scramble
from repro_torch.kernels.api import Epilogue, GemmSpec, apply_epilogue  # re-exports

__all__ = [
    "apply_epilogue",
    "get_default_backend",
    "matmul",
    "scramble_blocks",
    "set_default_backend",
]

# The scrambled-output alias: scrambled output is a *structure* of the spec,
# but the string keeps routing for legacy callers.
_SCRAMBLED_ALIAS = "cuda_mesh_scrambled"

# Set only by the deprecated set_default_backend; None = defer to the api
# default (the scoped default_backend context manager), then "torch".
# _LEGACY_EPOCH records api.default_epoch() at install time: any later
# set_default/default_backend change supersedes the legacy string entirely.
_LEGACY_DEFAULT: Optional[str] = None
_LEGACY_EPOCH: Optional[int] = None

_WARNED: set = set()


def _warn_once(kind: str, message: str, stacklevel: int = 3) -> None:
    """Deprecation warnings fire once per process per kind, attributed to the
    *external* caller of the public shim function — never to this module."""
    if kind in _WARNED:
        return
    _WARNED.add(kind)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def _valid_names() -> tuple:
    return tuple(api.backend_names()) + (_SCRAMBLED_ALIAS,)


def _split_legacy(name: str) -> tuple:
    """Legacy backend string -> (registry backend, structure)."""
    if name == _SCRAMBLED_ALIAS:
        _warn_once(
            "scrambled-pseudo-backend",
            f"backend={_SCRAMBLED_ALIAS!r} is deprecated; use "
            "GemmSpec(structure='scrambled') with the 'cuda_mesh' backend",
            stacklevel=4,  # _warn_once -> here -> matmul -> external caller
        )
        return "cuda_mesh", "scrambled"
    return name, "general"


def set_default_backend(backend: str) -> None:
    """Deprecated: install a process-wide default backend string.

    Prefer the scoped `api.default_backend(name)` context manager, or pass
    `backend=` to `api.plan` explicitly.
    """
    global _LEGACY_DEFAULT, _LEGACY_EPOCH
    if backend not in _valid_names():
        raise ValueError(f"backend must be one of {_valid_names()}, got {backend!r}")
    _warn_once(  # after validation: a typo'd call must not consume the warning
        "set-default-backend",
        "set_default_backend is deprecated; use the "
        "repro_torch.kernels.api.default_backend(...) context manager or "
        "plan(spec, backend=...)",
    )
    _LEGACY_DEFAULT = backend
    api.set_default("cuda_mesh" if backend == _SCRAMBLED_ALIAS else backend)
    _LEGACY_EPOCH = api.default_epoch()


def get_default_backend() -> str:
    return _default_name()


def _default_name() -> str:
    """Default resolution for calls without backend=: the legacy string holds
    only while the api default is *still the one set_default_backend
    installed* (epoch check) — so a `cuda_mesh_scrambled` default retains
    its scrambled structure, but any newer api.set_default / default_backend
    scope (including None for auto-choice) supersedes it."""
    if _LEGACY_DEFAULT is not None and _LEGACY_EPOCH == api.default_epoch():
        return _LEGACY_DEFAULT
    return api.get_default() or "torch"


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    backend: Optional[str] = None,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    stagger: bool = True,
    out_dtype=None,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """General fused matmul over the trailing two dims: (..., M, K) @ (K, N)
    or batched (..., M, K) @ (..., K, N).

    Compat shim: builds a `GemmSpec` and routes through `api.plan` on the
    operands' device — the plan cache makes repeated calls with the same
    logical shape cheap.  Epilogue contract (all backends): y = act(a @ b +
    bias) + residual, f32 accumulate, cast to out_dtype at the end.  bias is
    (N,); residual matches the output shape.  Block sizes left as None take
    the planner's defaults.
    """
    if backend is not None:
        if backend not in _valid_names():
            raise ValueError(f"backend must be one of {_valid_names()}, got {backend!r}")
        _warn_once(  # after validation: a typo'd call must not consume it
            "string-backend",
            "passing backend= strings to ops.matmul is deprecated; build a "
            "GemmSpec and call repro_torch.kernels.api.plan(spec, backend=...)",
        )
    name, structure = _split_legacy(backend or _default_name())
    blocks = None if block_m is block_n is block_k is None else (block_m, block_n, block_k)
    spec = GemmSpec.from_operands(
        a,
        b,
        structure=structure,
        epilogue=Epilogue(
            bias=bias is not None,
            activation=activation,
            residual=residual is not None,
        ),
        out_dtype=out_dtype,
        blocks=blocks,
        stagger=stagger,
    )
    return api.plan(spec, backend=name, device=a.device)(a, b, bias=bias, residual=residual)


class _ScrambleBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_m, block_n, k):
        ctx.opts = (block_m, block_n, k)
        return _scramble.scramble_blocks(x, block_m=block_m, block_n=block_n, k=k)

    @staticmethod
    def backward(ctx, g):
        block_m, block_n, k = ctx.opts
        dx = _ScrambleBlocks.apply(g, block_m, block_n, -k)
        return dx, None, None, None


def scramble_blocks(
    x: torch.Tensor, *, block_m: int = 128, block_n: int = 128, k: int = 1
) -> torch.Tensor:
    """S^k at block granularity on the trailing (m, n) dims, differentiable."""
    return _ScrambleBlocks.apply(x, block_m, block_n, k)
