"""Overlapped collective-matmul building blocks (port of
`repro.parallel.collectives`).

Tensor-parallel layers do `all_gather(x) @ W` or `reduce_scatter(x @ W)`
as two serial phases; these ring variants fuse the neighbour exchanges with
the local products.  Each helper has two selectable dataflows:

  overlap=False   the serial oracle: each ring step's hop waits for the
                  step's product.
  overlap=True    double-buffered: the hop of the next shard is posted
                  (`isend`/`irecv`) before the product of this one runs, and
                  waited after it, so the transfer and the kernel overlap.
                  The products and the accumulation order are the serial
                  path's, so the outputs are bitwise-equal to it.

SPMD in place of `shard_map`: every process runs the same function on its
own shard, and `jax.lax.ppermute` becomes `dist.batch_isend_irecv` over a
send to one ring neighbour and a receive from the other (`_Hop`).  A ring
is an axis of a device mesh (`parallel.sharding.mesh_layout`): `axis` names
it and `mesh` holds it.  Under the gloo backend a CUDA tensor's hop is
staged through host memory (gloo moves host buffers only); NCCL moves it in
place.  On a ring of size 1 nothing moves.

The planner's sharded schedules (`kernels/api.py`: `allgather_a[_overlap]`,
`reduce_scatter_k[_overlap]`, `pipeline`) run their per-shard products
through the `matmul=` hook, so each local product is the plan's own
backend: K1 on the card, its plain version on the CPU.  Every helper checks
the `collective.step` fault site on entry, and the double-buffered ones at
each step as well (with its step index), as the reference does.

The data- and tensor-parallel layers' helpers live here too, outside
`__all__` (which is the reference's): `all_reduce`, `all_gather` and
`reduce_scatter` (a copy reduced, concatenated or reduced and cut over a
group, staged under gloo), `axis_group` (the process group along mesh
axes), `mesh_groups` (one group per mesh axis) and `raise_together` (one
flag all-reduce per group, so that every rank raises when one fails).

Tensor-parallel training differentiates through them, and every
collective's backward is its linear adjoint.  The convention is GSPMD's:
a rank's gradient of a tensor that the 'model' ranks replicate is that
rank's share of the true gradient, and the true gradient is the sum of the
shares over the 'model' ranks; a rank's gradient of its own block is the
true gradient of that block.  So:

  all_reduce (sum)  backward: an all-reduce of the incoming gradient over
                    the same group (the shares summed, on every rank).
                    The row-parallel partials (`layers.dense_rows`), the
                    vocab-parallel embedding and the MoE combines take it.
  all_gather        backward: a reduce-scatter, the shares summed and this
                    rank's block kept.
  reduce_scatter    backward: an all-gather.
  a slice of a dim that arrives whole (`sharding.constrain`'s narrow):
                    autograd's own zero pad, already a share.
  column-parallel products need nothing at their input: x W_r's input
                    gradient is rank r's share.
  the loss          computed identically on every 'model' rank, so its
                    backward is seeded with 1/M (M the 'model' axis's
                    size): the shares sum to 1 (`train_step`).
  leaves that the 'model' ranks replicate: after the backward their
                    gradient is a share, all-reduced in f32 over 'model'
                    (`interop.model_blocks`), then over 'data'.

Every backward all-reduce runs in f32 whatever the forward's dtype (gloo
sums bf16 hop by hop, which is not a sum of partial gradients), and
returns the gradient in the input's dtype.  `all_reduce` with another op
(MAX, MIN: the loss's row maxima, a flag) carries no gradient.  Every rank
issues the same collectives in the same order, the backward's included:
the graph is the same on every rank, and a recomputed region (remat)
repeats its forward all-reduces on every rank alike.  `traffic` counts
the collectives this process issued and their bytes; `record_collectives`
lists each one as (kind, payload bytes, group size), the ring hops of
`_Hop` too, for the dry runs' link-byte accounting (`launch/hlo_stats.py`):
an all-gather's payload is its gathered result, and `reduce_scatter` is
recorded as the all-reduce it issues.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import MeshLayout, mesh_layout, mesh_shape
from repro_torch.resilience import faults

__all__ = [
    "matmul_ring_reducescatter",
    "psum_if_multi",
    "ring_allgather_matmul",
    "ring_pipeline_matmul",
]

# Per-step local product hook: (chunk, weights) -> f32 partial.  None selects
# a plain f32 matmul; ShardedPlan passes its per-shard Plan executor here.
MatmulFn = Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]


def _default_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def _shift(p: int, by: int = 1):
    return [(s, (s - by) % p) for s in range(p)]


def _staged(x: torch.Tensor) -> bool:
    """A CUDA tensor under gloo travels through host memory."""
    return x.is_cuda and dist.get_backend() == "gloo"


# Open `record_collectives` logs; each collective appends its record to all.
_RECORDERS: List[list] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[list]:
    """Yields a list that receives (kind, payload bytes, group size) for
    every collective this process issues inside the block: "all-reduce"
    (payload: the reduced tensor), "all-gather" (payload: the gathered
    result) and "collective-permute" (a ring hop; payload: the sent
    tensor), the names of XLA's HLO ops."""
    log: list = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def note_collective(kind: str, nbytes: int, n: int) -> None:
    """Adds one collective's record to every open `record_collectives` log
    (for a collective issued outside this module: `moe`'s counts)."""
    for log in _RECORDERS:
        log.append((kind, int(nbytes), int(n)))


class _Hop:
    """One ppermute in flight over a ring: this process sends `x` to the
    rank `perm` maps its index to and receives from the rank that maps to
    it.  `wait()` returns the received tensor (once; later calls return it
    again).  `ranks` are the ring's global ranks in index order."""

    def __init__(self, x: torch.Tensor, ranks: Sequence[int], idx: int, perm, tag: int = 0):
        dst = next(d for s, d in perm if s == idx)
        src = next(s for s, d in perm if d == idx)
        self._out, self._works, self._device = None, [], x.device
        if dst == idx and src == idx:
            self._out = x
            return
        send = x.detach().contiguous()
        note_collective("collective-permute", send.numel() * send.element_size(), len(ranks))
        if _staged(send):
            send = send.cpu()
        self._buf = torch.empty_like(send)
        self._send = send  # alive until the transfer completes
        ops = [dist.P2POp(dist.isend, send, int(ranks[dst]), tag=tag),
               dist.P2POp(dist.irecv, self._buf, int(ranks[src]), tag=tag)]
        self._works = dist.batch_isend_irecv(ops)

    def wait(self) -> torch.Tensor:
        if self._out is None:
            for w in self._works:
                w.wait()
            self._out = self._buf.to(self._device)
        return self._out


@contextlib.contextmanager
def _hops(ranks: Sequence[int], idx: int) -> Iterator[Callable[..., _Hop]]:
    """`start(x, perm, tag)` posts a hop; every hop posted is waited for on
    the way out, so a fault raised mid-ring leaves no transfer pending on
    any rank (every rank raises at the same step)."""
    live: List[_Hop] = []

    def start(x, perm, tag: int = 0) -> _Hop:
        live.append(_Hop(x, ranks, idx, perm, tag))
        return live[-1]

    try:
        yield start
    finally:
        for h in live:
            h.wait()


def _ppermute(x: torch.Tensor, ranks: Sequence[int], idx: int, perm) -> torch.Tensor:
    return _Hop(x, ranks, idx, perm).wait()


def _ring(axis: str, mesh):
    """(size, index, global ranks) of the ring along `axis`."""
    return mesh_layout(mesh).ring(axis)


def ring_allgather_matmul(
    x_blk: torch.Tensor,
    w: torch.Tensor,
    axis: str,
    *,
    mesh,
    matmul: MatmulFn = None,
    overlap: bool = False,
) -> torch.Tensor:
    """Computes all_gather(x, axis) @ w without materializing the gather.

    x_blk: local (m_blk, k) shard of a row-sharded X (full X is (p*m_blk,
    k)); w: replicated (k, n).  Returns the full (p*m_blk, n) product on
    every rank.  Each rank computes its own (m_blk, n) partial ONCE and the
    f32 result chunks hop the ring, not the input chunks.

    overlap=True splits the local product into two column halves: the
    first half's chunk is on the wire while the second half's product runs,
    and the two chains' hops and writes interleave.  A `matmul` hook then
    receives (m_blk, k) @ (k, n/2) halves.
    """
    sched = "allgather_a_overlap" if overlap else "allgather_a"
    faults.check("collective.step", schedule=sched, axis=axis)
    mm = matmul or _default_mm
    p, idx, ranks = _ring(axis, mesh)
    m_blk, n = x_blk.shape[0], w.shape[1]
    out = torch.zeros((p * m_blk, n), dtype=torch.promote_types(x_blk.dtype, torch.float32),
                      device=x_blk.device)

    def rows(src: int) -> slice:
        return slice(src * m_blk, (src + 1) * m_blk)

    if not overlap or p == 1 or n < 2:
        cur = mm(x_blk, w)  # the ONE local kernel call
        for t in range(p):
            out[rows((idx + t) % p)] = cur  # computed by rank (idx + t) mod p
            if t < p - 1:
                cur = _ppermute(cur, ranks, idx, _shift(p, 1))
        return out

    n2 = n // 2
    with _hops(ranks, idx) as hop:
        cur0 = mm(x_blk, w[:, :n2])
        out[rows(idx), :n2] = cur0
        h0 = hop(cur0, _shift(p, 1), 0)
        cur1 = mm(x_blk, w[:, n2:])  # half 0's chunk is on the wire meanwhile
        out[rows(idx), n2:] = cur1
        h1 = hop(cur1, _shift(p, 1), 1)
        for t in range(1, p):
            faults.check("collective.step", schedule=sched, axis=axis, step=t)
            cur0, cur1 = h0.wait(), h1.wait()
            out[rows((idx + t) % p), :n2] = cur0
            out[rows((idx + t) % p), n2:] = cur1
            if t < p - 1:
                h0 = hop(cur0, _shift(p, 1), 0)
                h1 = hop(cur1, _shift(p, 1), 1)
    return out


def matmul_ring_reducescatter(
    x: torch.Tensor,
    w_blk: torch.Tensor,
    axis: str,
    *,
    mesh,
    matmul: MatmulFn = None,
    overlap: bool = False,
) -> torch.Tensor:
    """Computes reduce_scatter(x @ w_col_shards) with ring accumulation.

    x: local (m, k_blk) shard of a column-sharded X; w_blk: local (k_blk,
    n).  Each rank ends with its (m/p, n) row slice of sum_k X_k @ W_k.

    overlap=True posts step t's accumulator hop before step t+1's product
    (which reads only resident operands) and waits after it.  The
    accumulator receives the same partials in the same order either way.
    """
    sched = "reduce_scatter_k_overlap" if overlap else "reduce_scatter_k"
    faults.check("collective.step", schedule=sched, axis=axis)
    mm = matmul or _default_mm
    p, idx, ranks = _ring(axis, mesh)
    m, n = x.shape[0], w_blk.shape[1]
    if m % p:
        raise ValueError(f"rows {m} not divisible by ring size {p}")
    mb = m // p

    def rows_for(step: int) -> torch.Tensor:
        # The chain that ENDS at rank r is held by rank r + (p-1-t) at step
        # t, so rank `idx` at step t adds the rows destined for
        # (idx + t + 1) mod p.
        dst = (idx + step + 1) % p
        return x[dst * mb:(dst + 1) * mb]

    acc = torch.zeros((mb, n), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    if not overlap:
        for t in range(p):
            acc = acc + mm(rows_for(t), w_blk)
            if t < p - 1:
                acc = _ppermute(acc, ranks, idx, _shift(p, 1))
        return acc

    with _hops(ranks, idx) as hop:
        part = mm(rows_for(0), w_blk)
        for t in range(p):
            acc = acc + part
            if t < p - 1:
                faults.check("collective.step", schedule=sched, axis=axis, step=t)
                h = hop(acc, _shift(p, 1))
                part = mm(rows_for(t + 1), w_blk)  # while the hop is in flight
                acc = h.wait()
    return acc


def ring_pipeline_matmul(
    x: torch.Tensor,
    w_blk: torch.Tensor,
    axis: str,
    *,
    mesh,
    microbatches: int,
    matmul: MatmulFn = None,
) -> torch.Tensor:
    """1F1B-microbatched reduce-scatter: the planner's `pipeline` schedule.

    The contract of `matmul_ring_reducescatter`, with each rank's row block
    split into `microbatches/p` sub-slices whose accumulator chains flow
    through the ring one tick apart: at each tick one hop is in flight
    behind one product.  `microbatches` must be a positive multiple of the
    ring size and divide m.  Rows accumulate in the reduce-scatter's ring
    order, so the output is bitwise-equal to it.
    """
    faults.check("collective.step", schedule="pipeline", axis=axis)
    mm = matmul or _default_mm
    p, idx, ranks = _ring(axis, mesh)
    m, n = x.shape[0], w_blk.shape[1]
    if microbatches % p or microbatches <= 0:
        raise ValueError(
            f"microbatches {microbatches} must be a positive multiple of the ring size {p}")
    if m % microbatches:
        raise ValueError(f"rows {m} not divisible by microbatches {microbatches}")
    f = microbatches // p  # chains per rank (pipeline rounds)
    mb = m // p  # rows this rank ends with
    msb = mb // f  # rows per microbatch chain

    def part_for(rnd: int, step: int) -> torch.Tensor:
        dst = (idx + step + 1) % p
        r0 = dst * mb + rnd * msb
        return mm(x[r0:r0 + msb], w_blk)

    outs = []
    with _hops(ranks, idx) as hop:
        part = part_for(0, 0)  # fill: the first microbatch's product
        for rnd in range(f):
            acc = torch.zeros((msb, n), dtype=torch.promote_types(x.dtype, torch.float32),
                              device=x.device)
            for t in range(p):
                acc = acc + part
                if rnd == f - 1 and t == p - 1:
                    break  # drain: the last chain's final add, nothing in flight
                faults.check("collective.step", schedule="pipeline", axis=axis, step=(rnd, t))
                nrnd, nt = (rnd, t + 1) if t < p - 1 else (rnd + 1, 0)
                h = hop(acc, _shift(p, 1)) if t < p - 1 else None
                part = part_for(nrnd, nt)  # steady state: the hop overlaps it
                if h is not None:
                    acc = h.wait()
            outs.append(acc)
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def psum_if_multi(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """Sum over the ring along `axis`; x itself where the mesh has no such
    axis or it has size 1 (mesh-shape agnostic)."""
    if mesh is None or mesh_shape(mesh).get(axis, 1) <= 1:
        return x
    return all_reduce(x, group=mesh.get_group(axis))


# Collectives this process issued (forward and backward) and their payload
# bytes, by kind; a caller resets them to read one step's.
traffic = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def _count(kind: str, x: torch.Tensor) -> None:
    traffic[kind] += 1
    traffic[kind + "_bytes"] += x.numel() * x.element_size()


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    buf = x.detach().cpu() if _staged(x) else x.detach().clone()
    _count("all_reduce", buf)
    note_collective("all-reduce", buf.numel() * buf.element_size(), dist.get_world_size(group))
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.detach().contiguous()
    buf = src.cpu() if _staged(src) else src
    _count("all_gather", buf)
    n = dist.get_world_size(group)
    note_collective("all-gather", n * buf.numel() * buf.element_size(), n)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size)


def _f32_sum(g: torch.Tensor, group) -> torch.Tensor:
    """The shares `g` summed over `group` in f32, in g's dtype."""
    return _reduce(g.float(), dist.ReduceOp.SUM, group).to(g.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _f32_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(_f32_sum(g, ctx.group), ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(_reduce(x, dist.ReduceOp.SUM, group), dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """`x` reduced over `group` (None: the default group), as a new tensor
    on x's device; a CUDA tensor under gloo is staged through host memory.
    The reduction runs in x's dtype: callers reduce in f32 (gloo sums bf16
    in bf16, hop by hop) and integer payloads as int32 (int8 overflows).
    A sum is differentiable (its backward sums the incoming gradient over
    the group, in f32: module docstring); other ops carry no gradient."""
    if op == dist.ReduceOp.SUM:
        return _AllReduceSum.apply(x, group)
    return _reduce(x, op, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks `x` of the ranks of `group`, concatenated along `dim` in
    the group's rank order (a mesh axis's coordinate order), as a new
    tensor on x's device; staged through host memory under gloo.  Its
    backward is a reduce-scatter of the incoming gradient."""
    if group is None:
        return x
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along `dim` of `x` summed over `group` (the
    blocks in the group's rank order), as a new tensor on x's device.  It
    is an all-reduce and a cut (gloo has no reduce-scatter of its own);
    its backward is an all-gather."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, dim, group)


def axis_group(mesh, axes) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(group, size, this process's index) of the ranks that differ from
    this one only along the mesh axes `axes` (a name or a tuple; axes the
    mesh lacks are skipped).  Size 1 gives group None.  `mesh` None means
    the default group: every rank, or one rank with no process group."""
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return None, 1, 0
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    lay = mesh_layout(mesh)
    names = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                  if lay.shape.get(a, 1) > 1)
    idx, size = _flat_index(lay.shape, lay.coord, names)
    if size == 1:
        return None, 1, 0
    if len(names) > 1:  # ('pod', 'data'): one group over the axes, in mesh order
        return _flat_group(mesh, names), size, idx
    return mesh.get_group(names[0]), size, idx


def _flat_group(mesh, names) -> dist.ProcessGroup:
    """The process group of the DeviceMesh axes `names` (in mesh order)
    flattened into one, its ranks in `_flat_index` order; made once per
    mesh and axes (`DeviceMesh._flatten`)."""
    key = (id(mesh), names)
    seen = _FLAT_GROUPS.get(key)
    if seen is None or seen[0]() is not mesh:
        order = [n for n in mesh.mesh_dim_names if n in names]
        if tuple(order) != tuple(names):
            raise ValueError(f"mesh axes {names} are not in the mesh's order {order}")
        group = mesh[names]._flatten("_".join(names)).get_group()
        ref = weakref.ref(mesh, lambda _, k=key: _FLAT_GROUPS.pop(k, None))
        seen = _FLAT_GROUPS[key] = (ref, group)
    return seen[1]


# (id(DeviceMesh), axes) -> (weakref to the mesh, its flattened group).
_FLAT_GROUPS: dict = {}


def mesh_groups(mesh) -> list:
    """The process group along each axis of `mesh` of more than one rank,
    in mesh order: one collective over each in turn reaches every rank of
    the mesh (`collectives.raise_together`, `train_loop`'s barrier)."""
    if mesh is None:
        return []
    return [axis_group(mesh, name)[0] for name, size in mesh_shape(mesh).items() if size > 1]


def raise_together(error: Optional[BaseException], group, device) -> None:
    """One all-reduce of a failure flag over `group` (or over each group of
    a sequence in turn, which reaches every rank of a mesh whose axes they
    are): if any rank passes an error, every rank raises (its own error,
    or one naming the others), so no rank goes on into a collective that
    the failed rank never joins.  On meta tensors (the dry runs' trace of
    one rank's step) the flag's all-reduces are issued and the host read
    is left out: a meta flag holds no value."""
    groups = [g for g in (group if isinstance(group, (list, tuple)) else (group,))
              if g is not None]
    flag = torch.tensor(0 if error is None else 1, dtype=torch.int32, device=device)
    for g in groups:
        flag = _reduce(flag, dist.ReduceOp.MAX, g)
    if groups and flag.device.type != "meta" and int(flag):
        raise error or RuntimeError("another rank failed this step")
    if error is not None:
        raise error


# -- SPMD shards of global operands ---------------------------------------------


def _flat_index(shape, coord, axes):
    idx, count = 0, 1
    for name in (axes,) if isinstance(axes, str) else (axes or ()):
        idx = idx * shape[name] + coord[name]
        count *= shape[name]
    return idx, count


def local_shard(x: torch.Tensor, spec, lay: MeshLayout) -> torch.Tensor:
    """This process's block of the global `x` under the PartitionSpec
    `spec` (the shard_map in_spec): each partitioned dim is cut into as
    many equal chunks as its axes' sizes multiply to."""
    for d, axes in enumerate(spec):
        idx, count = _flat_index(lay.shape, lay.coord, axes)
        if count > 1:
            size = x.shape[d] // count
            x = x.narrow(d, idx * size, size)
    return x


def assemble(blk: torch.Tensor, spec, lay: MeshLayout) -> torch.Tensor:
    """The global tensor whose blocks the mesh's processes hold under the
    PartitionSpec `spec` (the shard_map out_spec), on every process: the
    blocks are all-gathered over the default group, which the mesh must
    span, as bytes (staged through host memory under gloo)."""
    sharded = [d for d, axes in enumerate(spec) if _flat_index(lay.shape, lay.coord, axes)[1] > 1]
    if not sharded:
        return blk
    world = dist.get_world_size()
    if lay.ranks is None or lay.ranks.size != world:
        raise ValueError(f"a sharded output needs a mesh over all {world} ranks")
    blk = blk.contiguous()
    raw = blk.reshape(-1).view(torch.uint8)
    if _staged(raw):
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(world)]
    dist.all_gather(parts, raw)
    full = list(blk.shape)
    for d in sharded:
        full[d] *= _flat_index(lay.shape, lay.coord, spec[d])[1]
    out = blk.new_empty(full)
    for coord in np.ndindex(lay.ranks.shape):
        at = dict(zip(lay.shape, coord))
        piece = parts[int(lay.ranks[coord])].to(blk.device).view(blk.dtype).reshape(blk.shape)
        region = []
        for d in range(blk.dim()):
            i = _flat_index(lay.shape, at, spec[d])[0] if d < len(spec) else 0
            region.append(slice(i * blk.shape[d], (i + 1) * blk.shape[d]))
        out[tuple(region)] = piece
    return out
