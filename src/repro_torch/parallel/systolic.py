"""Distributed systolic matmul: the mesh array across devices (port of
`repro.parallel.systolic`).

The paper's array is a grid of MACs with nearest-neighbour wires; a group
of devices is a grid of processors with links between them.  This module
runs C = A @ B with A, B, C block-sharded over a square (p x p) mesh of
processes with Cannon's schedule, the block-level form of the systolic
array:

  * A physical systolic fabric pays the skew: hop-by-hop pre-alignment
    costs up to p-1 neighbour steps, so naive aligned Cannon takes about
    2p-1 collective phases, the analogue of the standard array's 3n-2.
  * A switched network moves any permutation in one phase.  The whole
    alignment is one permutation over the flattened 2D mesh (row i shifts
    by i), so the schedule takes p+1 phases: the paper's 2n-1-style saving,
    delivered by routing instead of output scrambling.
  * Each step's rotations read only the current blocks, never the step's
    product, so they are posted before the product and waited after it
    (double buffering).

`phase_counts()` reports the collective-phase arithmetic;
`systolic_matmul` is the entry point on global operands.

`ring_systolic_kpass` is the 1D-ring form of the same principle and the
backend of the planner's `ring_k` schedule (`kernels/api.py`): with A
column- and B row-sharded over K, p accumulator wavefronts circulate the
ring, each picking up the resident partial product as it passes, so
partial products flow through neighbours instead of returning to a central
reduction point: the paper's 2n-1 staggered feed at device granularity.

SPMD: every process runs these functions on its own blocks; the hops are
`parallel.collectives._Hop` (`dist.batch_isend_irecv`), staged through
host memory for CUDA tensors under gloo.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.parallel.collectives import (
    _default_mm,
    _hops,
    _ppermute,
    _ring,
    _shift,
    assemble,
    local_shard,
)
from repro_torch.parallel.sharding import PartitionSpec, mesh_layout, mesh_shape
from repro_torch.resilience import faults

__all__ = [
    "phase_counts",
    "ring_systolic_kpass",
    "systolic_matmul",
    "systolic_matmul_shardmap",
]


def _shift_perm(p: int, shift: int) -> List[Tuple[int, int]]:
    """Uniform circular shift along one axis: src -> (src - shift) mod p."""
    return [(s, (s - shift) % p) for s in range(p)]


def _alignment_perm_2d(p: int, *, align_a: bool) -> List[Tuple[int, int]]:
    """Cannon pre-alignment as ONE permutation over the flattened (p, p) axes.

    A: device (i, j) must receive A-block (i, (i + j) mod p)  => row i shifts
       left by i.  B: device (i, j) must receive B-block ((i + j) mod p, j)
       => column j shifts up by j.  Flattened index = i * p + j.
    """
    perm = []
    for i in range(p):
        for j in range(p):
            if align_a:
                src = i * p + ((i + j) % p)
            else:
                src = ((i + j) % p) * p + j
            perm.append((src, i * p + j))
    return perm


def phase_counts(p: int) -> dict:
    """Collective-phase accounting, mirroring the paper's step counts.

    naive (hop-by-hop alignment, the 'standard array' analogue):
        (p-1) A-hops + (p-1) B-hops happen concurrently -> p-1 phases,
        then p compute steps with p-1 rotation phases hidden under them.
    switched (this module, the 'mesh array' analogue):
        1 alignment permute phase + p compute steps.
    1D K-pass (the planner's 'ring_k' / 'reduce_scatter_k' schedules):
        gather-then-compute sums partials through a ring all-reduce,
        2(p-1) phases — partials return to a central point, the 3n-2 regime;
        the ring-systolic pass flows them through neighbours in p-1 phases,
        the 2n-1 regime.
    """
    return {
        "p": p,
        "naive_phases": (p - 1) + p,  # 2p-1  ~ the 3n-2 regime
        "switched_phases": 1 + p,  # p+1  ~ the 2n-1 regime
        "kpass_psum_phases": 2 * (p - 1),  # ring all-reduce of partials
        "kpass_ring_phases": p - 1,  # ring_systolic_kpass wavefronts
        "paper_standard_steps": 3 * p - 2,
        "paper_mesh_steps": 2 * p - 1,
    }


def ring_systolic_kpass(
    a_blk: torch.Tensor,
    b_blk: torch.Tensor,
    *,
    axis: str,
    mesh,
    matmul: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    overlap: bool = False,
) -> torch.Tensor:
    """K-contraction over a device ring with systolic partial-product flow.

    a_blk: local (m, k/p) column shard of A; b_blk: local (k/p, n) row shard
    of B.  Each rank computes its partial product ONCE; p accumulator
    wavefronts then circulate the ring, each adding the resident partial as
    it passes.  After p-1 hops every rank holds the full C = sum_t A_t @
    B_t: a replicated output with no reduction tree.  Each rank's sum
    accumulates in ring order starting from its own partial, so f32
    results can differ across ranks in the last ulp (exact on
    integer-valued data).  `matmul` computes the one local product
    (default: a plain f32 matmul).

    overlap=True splits the partial into two column halves and staggers the
    chains: the first half's hop is in flight while the second half's
    product runs, and each later hop of one chain overlaps the other's add.
    Per chain the hop/add sequence is the serial loop's.
    """
    sched = "ring_k_overlap" if overlap else "ring_k"
    faults.check("collective.step", schedule=sched, axis=axis)
    mm = matmul or _default_mm
    p, idx, ranks = _ring(axis, mesh)
    n = b_blk.shape[1]
    if not overlap or p == 1 or n < 2:
        part = mm(a_blk, b_blk)
        acc = part
        for _ in range(p - 1):
            acc = _ppermute(acc, ranks, idx, _shift(p, 1)) + part
        return acc

    n2 = n // 2
    with _hops(ranks, idx) as hop:
        part0 = mm(a_blk, b_blk[:, :n2])
        h0 = hop(part0, _shift(p, 1), 0)
        part1 = mm(a_blk, b_blk[:, n2:])  # chain 0's first hop is in flight
        h1 = hop(part1, _shift(p, 1), 1)
        acc0, acc1 = h0.wait() + part0, h1.wait() + part1
        for t in range(p - 2):
            faults.check("collective.step", schedule=sched, axis=axis, step=t)
            h0, h1 = hop(acc0, _shift(p, 1), 0), hop(acc1, _shift(p, 1), 1)
            acc0, acc1 = h0.wait() + part0, h1.wait() + part1
    return torch.cat([acc0, acc1], dim=1)


def systolic_matmul_shardmap(
    a_blk: torch.Tensor,
    b_blk: torch.Tensor,
    *,
    axis_x: str,
    axis_y: str,
    p: int,
    mesh,
) -> torch.Tensor:
    """The per-process body: with a_blk = A[i, j] and b_blk = B[i, j]
    resident on the process at (i, j) of the mesh's (axis_x, axis_y) axes,
    returns the resident C[i, j] (f32), by Cannon's loop."""
    lay = mesh_layout(mesh)
    names = list(lay.shape)

    def rank_at(i: int, j: int) -> int:
        if lay.ranks is None:
            return 0
        at = tuple(i if n == axis_x else j if n == axis_y else lay.coord[n] for n in names)
        return int(lay.ranks[at])

    grid = [rank_at(i, j) for i in range(p) for j in range(p)]  # flattened index i * p + j
    me = lay.coord[axis_x] * p + lay.coord[axis_y]

    # Phase 0: single-permutation alignment (the switched network's skew removal).
    a_cur = _ppermute(a_blk, grid, me, _alignment_perm_2d(p, align_a=True))
    b_cur = _ppermute(b_blk, grid, me, _alignment_perm_2d(p, align_a=False))
    _, jy, ry = _ring(axis_y, mesh)
    _, ix, rx = _ring(axis_x, mesh)
    acc = torch.zeros((a_blk.shape[0], b_blk.shape[1]),
                      dtype=torch.promote_types(a_blk.dtype, torch.float32), device=a_blk.device)
    # The rotations read only the current blocks: posted before the step's
    # product, waited after it.
    for t in range(p):
        if t < p - 1:
            with _hops(ry, jy) as hop_y, _hops(rx, ix) as hop_x:
                ha = hop_y(a_cur, _shift_perm(p, 1), 0)
                hb = hop_x(b_cur, _shift_perm(p, 1), 1)
                partial = _default_mm(a_cur, b_cur)
                a_cur, b_cur = ha.wait(), hb.wait()
        else:
            partial = _default_mm(a_cur, b_cur)
        acc = acc + partial
    return acc


def systolic_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    axes: Tuple[str, str] = ("data", "model"),
    out_dtype=None,
) -> torch.Tensor:
    """C = A @ B with all three matrices block-sharded over a square 2D mesh.

    a: (M, K), b: (K, N), the global operands on every process; M, K
    divisible by the size of axes[0] and K, N by that of axes[1], which
    must be equal.  Returns the global C on every process.
    """
    axis_x, axis_y = axes
    shape = mesh_shape(mesh)
    p, p2 = shape[axis_x], shape[axis_y]
    if p != p2:
        raise ValueError(f"systolic matmul needs a square mesh, got {p}x{p2}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    for dim, div, what in ((m, p, "M"), (k, p, "K"), (n, p, "N")):
        if dim % div:
            raise ValueError(f"{what}={dim} not divisible by mesh dim {div}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    lay = mesh_layout(mesh)
    spec = PartitionSpec(axis_x, axis_y)
    c = systolic_matmul_shardmap(local_shard(a, spec, lay), local_shard(b, spec, lay),
                                 axis_x=axis_x, axis_y=axis_y, p=p, mesh=mesh)
    return assemble(c.to(out_dtype), spec, lay)
