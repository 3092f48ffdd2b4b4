"""Logical-axis sharding rules, device-mesh layouts and tree shardings (port
of `repro.parallel.sharding`).

Models name every dim with a *logical* axis ('batch', 'mlp', 'experts',
...); a `ShardingRules` table maps them to physical mesh axes, and
`logical_to_physical` turns a tuple of logical names into a
`PartitionSpec`: per tensor dim, the mesh axis (or axis tuple) that
partitions it, or None.  The default table is the reference's:

    batch    -> ('pod', 'data')     heads, kv_heads, mlp -> 'model'
    experts  -> 'model'             vocab -> 'model'; seq, embed -> None

A mesh is either a `torch.distributed.device_mesh.DeviceMesh` (named dims
over live ranks) or a plain layout, a mapping or sequence of (name, size)
pairs: `mesh_shape` reads the reference's `mesh.shape` (name -> size, in
mesh order) from both, so schedule resolution, `describe()` and the cost
model need no ranks.  `MeshLayout` adds this process's coordinate and the
global rank at every coordinate, which SPMD execution slices shards by.

`named_sharding` / `tree_shardings` map a parameter tree's logical axes
(`Model.logical_axes()`) to `NamedSharding` records, the reference's
`NamedSharding(mesh, spec)` as a frozen (mesh, PartitionSpec) pair;
`shard_of` slices this rank's block of a global tensor by its mesh
coordinate and `gather_global` all-gathers the blocks back (tests,
checkpoints).  `block_pieces` says which global ranges of each dim a
rank's block holds and along which mesh axes each is cut, and
`replicated_ranges` reads from them which parts of the block the ranks of
one axis all hold (tensor-parallel training sums their gradients over that
axis and nothing else).

`constrain` is the port's `with_sharding_constraint`, the one place a
tensor moves between two layouts of the same logical axes.  The reference
hands XLA a global array and a sharding, and GSPMD inserts whatever
collective reaches it; SPMD by hand holds each process's local block, so
`constrain` is told the global shape (`shape`, with None for a dim that
stays as the caller holds it) and, where it is not in the target layout
already, the layout the block is in now (`src`) or the mesh axes over
which it is a partial sum (`partial`).  It then checks the block's shape
against its layout and moves it: an all-gather of a dim sharded
otherwise, a slice of a dim that arrives whole, an all-reduce of a
partial sum.
The models call it through `models.layers.ShardCtx.c`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DEFAULT_RULES",
    "MeshLayout",
    "NamedSharding",
    "PARAM_RULES",
    "PartitionSpec",
    "SP_DECODE_RULES",
    "ShardingRules",
    "TRAIN_RULES",
    "block_pieces",
    "constrain",
    "fsdp_gathers",
    "gather_global",
    "logical_to_physical",
    "mesh_layout",
    "mesh_shape",
    "named_sharding",
    "replicated_ranges",
    "shard_of",
    "tree_shardings",
]


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis (a name or a tuple of names) that
    partitions it, or None; dims past the spec's length are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_DEFAULT: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": None,
    "seq_attn": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_rows": "model",
    "vocab": "model",
    "state": None,
    "kv_seq": None,
    "kv_batch": ("pod", "data"),
    "layers": None,
    "stage": "stage",
    "frames": None,
    "patches": None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical->physical table; `replace` builds variants."""

    table: Tuple[Tuple[str, Any], ...]

    @classmethod
    def make(cls, overrides: Optional[Mapping[str, Any]] = None) -> "ShardingRules":
        merged = dict(_DEFAULT)
        if overrides:
            merged.update(overrides)
        return cls(tuple(sorted(merged.items())))

    def get(self, logical: Optional[str]):
        if logical is None:
            return None
        d = dict(self.table)
        if logical not in d:
            raise KeyError(f"unknown logical axis {logical!r}")
        return d[logical]

    def replace(self, **overrides) -> "ShardingRules":
        d = dict(self.table)
        d.update(overrides)
        return ShardingRules(tuple(sorted(d.items())))


DEFAULT_RULES = ShardingRules.make()

# FSDP parameter rules: every weight's 'embed' dim is also sharded over the
# DP axes, so parameters and optimizer state shard across the full mesh
# (`fsdp_gathers`; the models gather a layer's weights just before use).
PARAM_RULES = DEFAULT_RULES.replace(embed=("pod", "data"))

# Megatron sequence parallelism for training: remat-saved layer-boundary
# carriers stored seq-sharded over 'model' (`models.transformer.seq_whole`
# gathers them where the next layer reads them).
TRAIN_RULES = DEFAULT_RULES.replace(seq_sp="model")

# Sequence-parallel decode: long-context KV caches and recurrent streams
# sharded along their length over 'data' (the batch is tiny there).
SP_DECODE_RULES = DEFAULT_RULES.replace(kv_seq=("pod", "data"), kv_batch=None, batch=None)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh, a (name, size)
    layout (mapping or pairs) or anything with such a `.shape` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    if isinstance(getattr(mesh, "shape", None), Mapping):
        mesh = mesh.shape
    items = mesh.items() if isinstance(mesh, Mapping) else mesh
    return {str(n): int(s) for n, s in items}


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh as SPMD execution reads it: axis names and sizes, this
    process's coordinate, and `ranks`, the global rank at every coordinate
    (None for a plain layout, whose axes all have size 1)."""

    shape: Dict[str, int]
    coord: Dict[str, int]
    ranks: Optional[np.ndarray]

    def ring(self, axis: str) -> Tuple[int, int, list]:
        """(size, this process's index, global ranks in index order) of the
        ring along `axis`, the other coordinates held at this process's."""
        size = self.shape[axis]
        if self.ranks is None:
            return size, 0, [0]
        names = list(self.shape)
        at = tuple(slice(None) if n == axis else self.coord[n] for n in names)
        return size, self.coord[axis], [int(r) for r in self.ranks[at]]


def mesh_layout(mesh) -> MeshLayout:
    """The `MeshLayout` of `mesh` for this process.  A plain layout needs
    no ranks, so every axis must have size 1; a DeviceMesh must hold this
    process's rank."""
    shape = mesh_shape(mesh)
    if getattr(mesh, "mesh_dim_names", None) is None:
        if math.prod(shape.values()) != 1:
            raise ValueError(
                f"mesh layout {shape} has axes of size > 1; executing across them needs a"
                " DeviceMesh over live ranks (launch/mesh.make_local_mesh)")
        return MeshLayout(shape, {n: 0 for n in shape}, None)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"this rank is not in the device mesh {shape}")
    return MeshLayout(shape, dict(zip(shape, coord)), mesh.mesh.cpu().numpy())


def _axes_on_mesh(mesh, axes):
    """Drop rule axes the mesh doesn't have (e.g. 'pod' on single-pod)."""
    if axes is None:
        return None
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return axes if axes in shape else None
    present = tuple(a for a in axes if a in shape)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def logical_to_physical(
    logical_axes: Sequence[Optional[str]],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> PartitionSpec:
    """('batch', 'seq', 'embed') -> PartitionSpec(('pod','data'), None, None)."""
    phys = [_axes_on_mesh(mesh, rules.get(ax)) for ax in logical_axes]
    # A physical axis may appear at most once in a spec; later wins -> None.
    seen = set()
    cleaned = []
    for a in phys:
        names = (a,) if isinstance(a, str) else (a or ())
        if any(n in seen for n in names):
            cleaned.append(None)
            continue
        seen.update(names)
        cleaned.append(a)
    return PartitionSpec(*cleaned)


def _axes_size(shape: Mapping[str, int], a) -> int:
    if a is None:
        return 1
    if isinstance(a, str):
        return shape[a]
    return math.prod(shape[x] for x in a)


# (spec, shape, mesh-shape) triples already warned about: each distinct drop
# warns exactly once.
_WARNED_DROPS: set = set()


def _drop_indivisible(spec: PartitionSpec, shape: Sequence[int], mesh) -> PartitionSpec:
    """Replicate any dim whose size doesn't divide by its mapped axes'
    product (odd published dims: vocab 49155, 40 heads against 16-way TP),
    warning once per distinct (spec, shape, mesh)."""
    mshape = mesh_shape(mesh)
    out, dropped = [], []
    for dim, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if a is None or dim % _axes_size(mshape, a) == 0:
            out.append(a)
        else:
            out.append(None)
            dropped.append((dim, a))
    if dropped:
        key = (tuple(spec), tuple(shape), tuple(mshape.items()))
        if key not in _WARNED_DROPS:
            _WARNED_DROPS.add(key)
            detail = ", ".join(
                f"dim {dim} % {_axes_size(mshape, a)} != 0 (axes {a!r})" for dim, a in dropped
            )
            warnings.warn(
                f"sharding {spec} of shape {tuple(shape)} fell back to replicated on"
                f" indivisible dim(s): {detail}",
                UserWarning,
                stacklevel=3,
            )
    return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies on a mesh: per dim, the mesh axes that partition
    it (`spec`).  `mesh` is a DeviceMesh or a plain (name, size) layout."""

    mesh: Any
    spec: PartitionSpec


def named_sharding(
    logical_axes: Sequence[Optional[str]],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    shape: Optional[Sequence[int]] = None,
) -> NamedSharding:
    """The sharding of a tensor with these logical axes; with `shape`, dims
    that do not divide by their axes' product fall back to replicated."""
    spec = logical_to_physical(logical_axes, mesh, rules)
    if shape is not None:
        spec = _drop_indivisible(spec, shape, mesh)
    return NamedSharding(mesh, spec)


def tree_shardings(logical_tree, mesh, rules: ShardingRules = DEFAULT_RULES, aval_tree=None):
    """A tree of logical-axis tuples (None: replicated) -> the same tree of
    NamedShardings.  With `aval_tree` (the matching tree of tensors, or
    anything with `.shape`), indivisible dims drop to replicated."""
    def one(axes, aval=None):
        if axes is None:
            return NamedSharding(mesh, PartitionSpec())
        return named_sharding(axes, mesh, rules, None if aval is None else aval.shape)

    def walk(node, aval):
        if isinstance(node, dict):
            return {k: walk(v, None if aval is None else aval[k]) for k, v in node.items()}
        return one(node, aval)

    return walk(logical_tree, aval_tree)


def shard_of(x, sharding: NamedSharding, layout: Optional[MeshLayout] = None):
    """This process's block of the global tensor `x` under `sharding`, cut
    by its coordinate on the mesh (`layout`, by default the mesh's own)."""
    from repro_torch.parallel.collectives import local_shard

    return local_shard(x, sharding.spec, layout or mesh_layout(sharding.mesh))


def gather_global(blk, sharding: NamedSharding, layout: Optional[MeshLayout] = None):
    """The inverse of `shard_of`: the global tensor, on every process, from
    the blocks the mesh's processes hold (an all-gather over the default
    group, which the mesh must span)."""
    from repro_torch.parallel.collectives import assemble

    return assemble(blk, sharding.spec, layout or mesh_layout(sharding.mesh))


def _count(shape: Mapping[str, int], a) -> int:
    return 1 if a is None else _axes_size(shape, a)


def block_pieces(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                 rules: ShardingRules = DEFAULT_RULES,
                 layout: Optional[MeshLayout] = None) -> Tuple[Tuple[Tuple[int, int, Any], ...],
                                                              ...]:
    """Per dim of a tensor of global `shape` laid out as `logical_axes` name
    it (indivisible dims replicated): the global ranges this process's
    block holds along it, in the block's order, as (start, size, axes),
    where `axes` are the mesh axes of more than one rank that cut the range
    (this process's own block of it), or None where every rank holds it
    whole.  `shard_of`'s cut, described; a fused dim whose block joins
    several ranges (`interop.shard_params`) has several pieces."""
    mshape = mesh_shape(mesh)
    spec = _drop_indivisible(logical_to_physical(logical_axes, mesh, rules), shape, mesh)
    lay = layout or mesh_layout(mesh)
    out = []
    for n, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        count = _count(mshape, a)
        if count == 1:
            out.append(((0, n, None),))
            continue
        from repro_torch.parallel.collectives import _flat_index

        idx, _ = _flat_index(lay.shape, lay.coord, a)
        out.append(((idx * (n // count), n // count, a),))
    return tuple(out)


def fsdp_gathers(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                 rules: ShardingRules, param_rules: ShardingRules) -> Tuple[Tuple[int, Any], ...]:
    """The (dim, mesh axes) all-gathers that take a leaf of global `shape`
    from its block under `param_rules` (FSDP: 'embed' also cut over the DP
    axes) to its block under the activation `rules`, which the model code
    reads: each dim that `param_rules` cuts and `rules` leaves whole
    (indivisible dims replicated under both).  Empty where the two agree.
    Raises NotImplementedError where they cut one dim differently."""
    pspec = _drop_indivisible(logical_to_physical(logical_axes, mesh, param_rules), shape, mesh)
    aspec = _drop_indivisible(logical_to_physical(logical_axes, mesh, rules), shape, mesh)
    mshape = mesh_shape(mesh)
    out = []
    for d in range(len(shape)):
        p = pspec[d] if d < len(pspec) else None
        a = aspec[d] if d < len(aspec) else None
        pc, ac = _count(mshape, p), _count(mshape, a)
        if pc == 1 and ac == 1 or p == a:
            continue
        if ac > 1:
            raise NotImplementedError(f"parameter rules cut dim {d} of {tuple(shape)} over {p!r}"
                                      f" where the activation rules cut it over {a!r}")
        out.append((d, p))
    return tuple(out)


def _names(axes) -> Tuple[str, ...]:
    return () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))


def replicated_ranges(pieces, axis: str):
    """Which parts of a block with these `block_pieces` every rank along
    the mesh axis `axis` holds alike: True (all of it), None (none: every
    element is this rank's own), or (dim, ((offset, size), ...)), the
    ranges of the block's dim `dim` that no cut along `axis` reaches while
    its other pieces are cut along it (a fused dim: Mamba2's B and C beside
    a rank's heads).  Raises ValueError where `axis` cuts several dims."""
    cut = [d for d, ps in enumerate(pieces) if any(axis in _names(a) for _, _, a in ps)]
    if not cut:
        return True
    if len(cut) > 1:
        raise ValueError(f"mesh axis {axis!r} cuts dims {cut} of one block")
    d, off, ranges = cut[0], 0, []
    for _, size, a in pieces[d]:
        if axis not in _names(a):
            ranges.append((off, size))
        off += size
    return (d, tuple(ranges)) if ranges else None


def constrain(
    x,
    logical_axes: Sequence[Optional[str]],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    *,
    shape: Optional[Sequence[Optional[int]]] = None,
    src: Optional[Sequence[Any]] = None,
    partial: Any = None,
    layout: Optional[MeshLayout] = None,
):
    """This process's block of a tensor of global `shape` laid out as
    `logical_axes` name it under `rules` (indivisible dims replicated, as
    the reference's `constrain`), from its block `x` in the layout `src`.

    `shape` None: `x` is the whole tensor (the reference's own reading of
    `x.shape`).  A None entry of `shape` leaves that dim as `x` holds it,
    unchecked (the batch rows inside a model, split once where they
    enter).  `src` None: each dim of `x` is whole if it has the global
    size, else already in the target layout.  `partial`: mesh axes (a name
    or tuple) over which `x` holds partial sums; they are all-reduced in
    x's dtype (callers pass f32 partials), after the moves above, on the
    block.
    Raises ValueError where the block's shape does not fit its layout.
    """
    from repro_torch.parallel import collectives

    mshape = mesh_shape(mesh)
    glob = tuple(x.shape) if shape is None else tuple(shape)
    if len(glob) != x.dim() or len(logical_axes) != x.dim():
        raise ValueError(f"constrain: block {tuple(x.shape)}, global shape {glob} and axes"
                         f" {tuple(logical_axes)} must have one entry per dim")
    dst = logical_to_physical(logical_axes, mesh, rules)
    known = [g if g is not None else max(1, _count(mshape, a)) for g, a in zip(glob, dst)]
    dst = tuple(_drop_indivisible(dst, known, mesh))
    if src is None:
        src = tuple(a if g is not None and n != g else None
                    for n, g, a in zip(x.shape, glob, dst))
    src = tuple(src) + (None,) * (x.dim() - len(tuple(src)))
    for d, (n, g, a) in enumerate(zip(x.shape, glob, src)):
        if g is not None and (g % _count(mshape, a) or n != g // _count(mshape, a)):
            raise ValueError(f"constrain: dim {d} of the block {tuple(x.shape)} is not the"
                             f" {a!r} block of a global {g} on mesh {mshape}")
    if math.prod(mshape.values()) == 1:
        return x
    lay = layout or mesh_layout(mesh)

    def block(x, d, g, axes):
        idx, count = collectives._flat_index(lay.shape, lay.coord, axes)
        return x.narrow(d, idx * (g // count), g // count)

    # Gathers first: a block of one dim must not be cut from another's
    # before the ranks' blocks are joined.  Partial sums commute with both.
    for d, (g, a, b) in enumerate(zip(glob, src, dst)):
        if g is not None and a is not None and a != b:
            x = collectives.all_gather(x, d, collectives.axis_group(mesh, a)[0])
            if b is not None:
                x = block(x, d, g, b)
    for d, (g, a, b) in enumerate(zip(glob, src, dst)):
        if g is not None and a is None and b is not None:  # whole -> this block
            x = block(x, d, g, b)
    if partial is not None and _count(mshape, partial) > 1:
        x = collectives.all_reduce(x, group=collectives.axis_group(mesh, partial)[0])
    return x
