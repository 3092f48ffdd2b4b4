"""Shared building blocks: param specs, norms, RoPE, the config-routed GEMM,
and `ShardCtx`, which threads a device mesh through the model code.

Port of `repro.models.layers`.  Each model family defines
a `param_specs(cfg)` tree whose leaves are `PSpec(shape, logical_axes,
scale, dtype, init)`; `init_params` materializes it from a
`torch.Generator` on an explicit device.  All GEMMs go through the
plan/execute API (`repro_torch.kernels.api`): `gemm` builds a typed
GemmSpec, `api.plan` resolves the backend once per logical shape
(cfg.use_mesh_kernel selects the mesh kernel), and the cached plan executes
per call; `grouped_gemm` does the same for the MoE experts' ragged
products.

Tensor parallelism is SPMD by hand: under a `ShardCtx` with a live
('data', 'model') mesh every process holds its own block of each weight
(`interop.shard_params`) and of each activation, and the model code calls
`torch.distributed` where GSPMD inserts a collective for the reference
(`ShardCtx` below).  Without a mesh, the default, nothing changes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import api as _api
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm

__all__ = [
    "NO_SHARD",
    "PSpec",
    "Part",
    "ShardCtx",
    "abstract_params",
    "apply_rope",
    "dense",
    "dense_rows",
    "gemm",
    "grouped_gemm",
    "init_params",
    "logical_axes_tree",
    "padded_vocab",
    "rmsnorm",
    "softmax_xent",
]


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declarative parameter: shape + logical axes + init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 0.02
    dtype: Any = None  # filled from cfg.param_dtype at materialization
    init: str = "normal"  # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _map_specs(fn, specs):
    if isinstance(specs, PSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def init_params(
    generator: torch.Generator, specs, dtype: torch.dtype, *, device
) -> Any:
    """Materialize a PSpec tree into tensors on `device`.

    Normal leaves draw N(0, 1) in f32 from `generator` (which must live on
    `device`), in the tree's key order, then scale (in place, so a leaf's
    transient is its f32 draw) and cast — the reference's recipe, with
    torch's generator in place of JAX's keys.
    """
    def make(s: PSpec) -> torch.Tensor:
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(s.scale).to(dt)

    return _map_specs(make, specs)


def abstract_params(specs, dtype: torch.dtype) -> Any:
    """The PSpec tree as tensors on the meta device: shapes and dtypes, no
    storage (the dry runs' abstract inputs, `launch/dryrun.py`)."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"),
                      specs)


def logical_axes_tree(specs) -> Any:
    """Matching tree of logical-axis tuples, for `parallel.sharding`."""
    return _map_specs(lambda s: s.axes, specs)


class Part(NamedTuple):
    """This process's block of a dim of `n` along a logical axis: rows
    [start, start + size) of n, cut `count` ways over the mesh `axes`
    (count 1, axes None: whole)."""

    start: int
    size: int
    count: int
    axes: Any


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threading (mesh, rules) through model code; None mesh = no layouts.

    `mesh` is a ('data', 'model') DeviceMesh over live ranks
    (`launch.mesh.make_local_mesh`), `rules` a `ShardingRules` table
    (DEFAULT_RULES when None).  Every model function takes one; the
    default `ShardCtx()` makes every method below the identity, so a
    single process computes exactly what it computes without the argument.

    `c(x, axes, shape)` is where the port states a tensor's layout, at the
    reference's `ctx.c` call sites.  It CHECKS that `x` is this process's
    block of a tensor of global `shape` laid out as `axes` name it
    (ValueError otherwise), and MOVES it there where the caller says how
    it differs: a dim that arrives whole (at its global size) is sliced
    into the layout, a dim sharded along other axes (`src`, a
    PartitionSpec) is all-gathered, and a partial sum (`partial`, a `Part`
    or mesh axes) is all-reduced.  A None entry of `shape` leaves that dim
    as `x` holds it: the batch rows, which the serving steps split over
    'data' before the model runs (`for_rows`) and which stay this
    process's after.  `shape` None reads `x` as the whole tensor, the
    reference's reading.  See `parallel.sharding.constrain`, which does
    the work.

    `param_rules` (None: `rules`) is the parameters' own layout where it
    differs, the reference's `param_rules` (FSDP, `PARAM_RULES`: every
    weight's 'embed' dim also cut over the DP axes).  The parameters and
    AdamW's moments are then this process's blocks under it
    (`interop.shard_params` cuts them by `params_ctx()`), and the model
    code calls `weights(tree, specs)` on a layer's parameters just before
    it reads them: each block is all-gathered into its layout under
    `rules` (`parallel.sharding.fsdp_gathers`), and the gathered copy is
    dropped with the layer.  The gather's backward is a reduce-scatter, so
    each process's gradient arrives as its block, summed over the DP axes.

    `part(axis, n)` is this process's `Part` of a dim of n along a logical
    axis (replicated where n does not divide the axis, the reference's
    `_drop_indivisible`); `gather(x, axes, shape)` all-gathers every dim
    the layout shards (the serving steps' logits, tests).
    """

    mesh: Any = None
    rules: Any = None
    # This process's place on the mesh where it is not the mesh's own (a
    # `parallel.sharding.MeshLayout`: laying out a rank's blocks without
    # ranks, as `interop.shard_params` tests do); None reads the mesh.
    layout: Any = None
    param_rules: Any = None

    @functools.cached_property
    def _resolved(self):
        from repro_torch.parallel import sharding

        rules = self.rules or sharding.DEFAULT_RULES
        shape = sharding.mesh_shape(self.mesh)
        live = self.mesh is not None and any(s > 1 for s in shape.values())
        lay = (self.layout or sharding.mesh_layout(self.mesh)) if live else None
        return rules, shape, lay

    @property
    def active(self) -> bool:
        """A mesh with an axis of more than one rank."""
        return self.mesh is not None and self._resolved[2] is not None

    def axis_size(self, name: str) -> int:
        """The size of mesh axis `name` (1 without a mesh or that axis)."""
        if self.mesh is None:
            return 1
        return self._resolved[1].get(name, 1)

    def axes_of(self, logical: str):
        """The mesh axes (a name or tuple) the rules map `logical` to, of
        more than one rank in all; None otherwise."""
        if not self.active:
            return None
        from repro_torch.parallel import sharding

        rules, shape, _ = self._resolved
        axes = sharding._axes_on_mesh(self.mesh, rules.get(logical))
        return axes if sharding._count(shape, axes) > 1 else None

    def part(self, logical: str, n: int) -> Part:
        if not self.active:
            return Part(0, n, 1, None)
        from repro_torch.parallel import collectives, sharding

        rules, shape, lay = self._resolved
        axes = sharding._axes_on_mesh(self.mesh, rules.get(logical))
        count = sharding._count(shape, axes)
        if count == 1 or n % count:
            return Part(0, n, 1, None)
        idx, _ = collectives._flat_index(lay.shape, lay.coord, axes)
        return Part(idx * (n // count), n // count, count, axes)

    def for_rows(self, n: int) -> "ShardCtx":
        """This ctx for a batch of n rows: itself where the rows split over
        the batch axes (or there are none), else the same mesh with the
        batch and its caches replicated (the rule for indivisible dims)."""
        if self.axes_of("batch") is None or self.part("batch", n).count > 1:
            return self
        return dataclasses.replace(
            self, rules=self._resolved[0].replace(batch=None, kv_batch=None))

    @property
    def fsdp(self) -> bool:
        """The parameters have a layout of their own (`param_rules`)."""
        return (self.active and self.param_rules is not None
                and self.param_rules != self._resolved[0])

    def params_ctx(self) -> "ShardCtx":
        """The ctx the parameters' blocks are laid out by: `param_rules` as
        the rules (itself without them)."""
        if not self.fsdp:
            return self
        return ShardCtx(self.mesh, self.param_rules, self.layout)

    @functools.cached_property
    def _gather_plans(self) -> dict:
        return {}

    def weights(self, tree: Any, specs: Any) -> Any:
        """`tree` (parameter blocks under `param_rules`, a dict tree) in the
        activation rules' layout: each leaf all-gathered along the dims
        `param_rules` cuts further (FSDP's per-layer gathers).  `specs` is
        the matching PSpec tree; a spec with more dims than its leaf (a
        stacked 'layers' spec of one layer's tensor) is read without its
        leading dims.  The identity without `param_rules`."""
        if not self.fsdp:
            return tree
        if isinstance(tree, dict):
            return {k: self.weights(v, specs[k]) for k, v in tree.items()}
        from repro_torch.parallel import collectives, sharding

        extra = len(specs.shape) - tree.dim()
        key = (specs.shape[extra:], specs.axes[extra:])
        plan = self._gather_plans.get(key)
        if plan is None:
            plan = self._gather_plans[key] = tuple(
                (d, collectives.axis_group(self.mesh, axes)[0])
                for d, axes in sharding.fsdp_gathers(key[0], key[1], self.mesh,
                                                     self._resolved[0], self.param_rules))
        for d, group in plan:
            tree = collectives.all_gather(tree, d, group)
        return tree

    def c(self, x: torch.Tensor, axes: Sequence[Optional[str]],
          shape: Optional[Sequence[Optional[int]]] = None, *, src=None,
          partial=None) -> torch.Tensor:
        if self.mesh is None:
            return x
        from repro_torch.parallel.sharding import constrain

        if isinstance(partial, Part):
            partial = partial.axes if partial.count > 1 else None
        rules, _, lay = self._resolved
        return constrain(x, axes, self.mesh, rules, shape=shape, src=src, partial=partial,
                         layout=lay)

    def gather(self, x: torch.Tensor, axes: Sequence[Optional[str]],
               shape: Sequence[Optional[int]]) -> torch.Tensor:
        if not self.active:
            return x
        from repro_torch.parallel.sharding import _count, logical_to_physical

        rules, mshape, _ = self._resolved
        spec = tuple(a if g is not None and g % _count(mshape, a) == 0 else None
                     for g, a in zip(shape, logical_to_physical(axes, self.mesh, rules)))
        return self.c(x, (None,) * x.dim(), shape, src=spec)


NO_SHARD = ShardCtx()


def padded_vocab(cfg) -> int:
    """Embedding/lm_head row count, padded to cfg.vocab_pad_multiple (0 =
    exact).  Padded logits are masked out of argmax."""
    m = cfg.vocab_pad_multiple
    if not m:
        return cfg.vocab_size
    return ((cfg.vocab_size + m - 1) // m) * m


def gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
    mesh: Any = None,
    shard: Any = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Config-routed GEMM via plan/execute: the `torch` backend, or the mesh
    kernel (`cuda_mesh`) when cfg.use_mesh_kernel.  The output is in x's
    type unless `out_dtype` names another (a row-parallel product's f32
    partial sums).

    The epilogue (y = act(xW + bias) + residual) is fused into the kernel on
    the mesh path and applied as plain ops on the torch backend — one call
    site, identical semantics.  Block shapes come from cfg.mesh_block_m/n/k
    when set (> 0).  Under autograd the plan runs its product as the op
    `repro_torch::gemm`, which the `dots` remat policy saves.

    With `shard` (a `kernels.api.ShardSpec`) and its device `mesh`, the
    plan is a ShardedPlan: the same per-shard product inside the
    ShardSpec's collective schedule, run by every rank of the mesh on the
    same global operands and returning the global result, so call sites do
    not change shape-wise.
    """
    backend = "cuda_mesh" if cfg.use_mesh_kernel else "torch"
    blocks = (cfg.mesh_block_m or None, cfg.mesh_block_n or None, cfg.mesh_block_k or None)
    spec = _api.GemmSpec.from_operands(
        x,
        w,
        epilogue=_api.Epilogue(
            bias=bias is not None,
            activation=activation,
            residual=residual is not None,
        ),
        out_dtype=out_dtype or x.dtype,
        blocks=blocks,
        shard=shard,
    )
    return _api.plan(spec, backend=backend, device=x.device, mesh=mesh)(
        x, w, bias=bias, residual=residual
    )


def grouped_gemm(
    tokens: torch.Tensor,  # (num_groups * rows_per_group, K), group-major
    group_offsets: torch.Tensor,  # (num_groups + 1,) cumulative valid-row counts
    weights: torch.Tensor,  # (num_groups, K, N) stacked per-group slabs
    cfg,
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Config-routed grouped (ragged-batch) GEMM via plan/execute.

    The MoE expert path: row blocks of the capacity-layout `tokens` buffer
    multiply their group's (K, N) weight slab in ONE kernel (K5 on the
    `cuda_mesh` backend when cfg.use_mesh_kernel, else a segment-masked
    `bmm` on the `torch` backend), with rows past each group's size coming
    back zero.  Plans are cached per logical group shape exactly like
    `gemm`: every layer and step reuses one plan per expert projection.
    The output is in the tokens' type unless `out_dtype` names another.
    """
    backend = "cuda_mesh" if cfg.use_mesh_kernel else "torch"
    num_groups, kd, n = weights.shape
    blocks = (cfg.mesh_block_m or None, cfg.mesh_block_n or None, cfg.mesh_block_k or None)
    spec = _api.GemmSpec.for_groups(
        _api.GroupSpec(num_groups, tokens.shape[0] // num_groups),
        k=kd,
        n=n,
        dtype_a=tokens.dtype,
        dtype_b=weights.dtype,
        out_dtype=out_dtype or tokens.dtype,
        blocks=blocks,
    )
    return _api.plan(spec, backend=backend, device=tokens.device)(tokens, group_offsets, weights)


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg,
    b: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
    mesh: Any = None,
    shard: Any = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dense projection with the fused epilogue: one kernel on the mesh path."""
    return gemm(x, w, cfg, bias=b, activation=activation, residual=residual, mesh=mesh,
                shard=shard, out_dtype=out_dtype)


def dense_rows(x: torch.Tensor, w: torch.Tensor, cfg, ctx: ShardCtx, part: Part,
               axes: Sequence[Optional[str]], shape: Sequence[Optional[int]]) -> torch.Tensor:
    """A row-parallel projection and its layout: `x`'s last dim and `w`'s
    rows are this process's `part` of the contraction.  Sharded, each
    process writes its f32 partial sums, which are all-reduced in f32 over
    the part's axes and then cast to x's type: the one f32 accumulation of
    the unsharded product, in another order.  Unsharded, it is `dense`
    followed by `ctx.c`, bit for bit the product without a mesh."""
    if part.count == 1:
        return ctx.c(dense(x, w, cfg), axes, shape)
    y = dense(x, w, cfg, out_dtype=torch.float32)
    return ctx.c(y, axes, shape, partial=part).to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The reference's rmsnorm: kernel R1 on the card, whose order of
    summation is fixed per row (`kernels.rmsnorm`), its plain version on
    CPU and meta tensors."""
    return _rmsnorm(x, gamma, eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) or (T,).  Rotate pairs (even, odd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv  # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, part: Optional[Part] = None,
                 ctx: ShardCtx = NO_SHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable mean token cross-entropy.  Returns (loss, acc).

    With `part` (this process's `Part` of the vocab under `ctx`, of more
    than one rank) the logits are this process's vocab columns, read
    without gathering them: a MAX all-reduce of the row maxima (detached),
    a sum all-reduce of each row's sum of exp and one of the gold logit
    (the label's column on the process that holds it, 0 elsewhere), and
    accuracy by the global argmax with the lowest index winning a tie, as
    `torch.argmax` on the whole row does.  The sums carry the gradient
    (`parallel.collectives`); the padded vocab columns' -1e30 add 0."""
    if part is None or part.count == 1:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        loss = torch.mean(lse - gold)
        acc = torch.mean((torch.argmax(lf, dim=-1) == labels).float())
        return loss, acc
    import torch.distributed as dist

    from repro_torch.parallel.collectives import all_reduce, axis_group

    group = axis_group(ctx.mesh, part.axes)[0]
    lf = logits.float()
    local_max, local_arg = torch.max(lf.detach(), dim=-1)
    row_max = all_reduce(local_max, dist.ReduceOp.MAX, group)
    sum_exp = all_reduce(torch.sum(torch.exp(lf - row_max[..., None]), dim=-1), group=group)
    lse = torch.log(sum_exp) + row_max
    idx = labels.long() - part.start
    mine = (idx >= 0) & (idx < part.size)
    gold = torch.gather(lf, -1, idx.clamp(0, part.size - 1)[..., None])[..., 0]
    gold = all_reduce(torch.where(mine, gold, torch.zeros_like(gold)), group=group)
    loss = torch.mean(lse - gold)
    # The global argmax: of the processes whose maximum is the row's, the
    # lowest global index.
    none = torch.iinfo(torch.int64).max
    cand = torch.where(local_max == row_max, local_arg + part.start,
                       torch.full_like(local_arg, none))
    arg = all_reduce(cand, dist.ReduceOp.MIN, group)
    acc = torch.mean((arg == labels.long()).float())
    return loss, acc
