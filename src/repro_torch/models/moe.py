"""Feed-forward blocks: dense SwiGLU and the routed Mixture-of-Experts block
(port of `repro.models.moe`).

Expert compute rides the grouped-GEMM planner: each (token, choice) pair is
ranked within its expert by a stable sort and scattered into a group-major
capacity buffer (expert e owns rows [e*rows_per_group, e*rows_per_group +
size_e)), and the two expert projections run as grouped plans
(`layers.grouped_gemm`), ONE ragged kernel per projection.  Small token
counts (n or per-group s <= 256: decode steps, one prompt) use cap = n,
exact drop-free routing; larger ones get cap = cf * n * k / e per expert and
may drop pairs.

Nothing here reads routing data on the host: sizes, offsets and the
scatter/gather indices stay on the device, and no op whose output size
depends on the data is used (`bincount` and `repeat_interleave` read
their input's size on the host, so counts are a `scatter_add_` and token
ids an integer division).

Shared experts (qwen2-moe): one fused SwiGLU of width moe_d_ff *
num_shared_experts that every token runs, scaled by a per-token sigmoid
gate, an f32 GEMM with N = 1 planned like every other projection.

Aux: Switch load-balance loss + router z-loss, returned for the train loop.

Data-parallel training (`global_routing`): the reference's pjit step
routes the GLOBAL batch, so capacity, each pair's rank within its expert
and the load-balance loss see every rank's tokens.  Inside
`global_routing(group, rows)` each rank holds a contiguous slice of the
global batch's `rows` rows (ranks in row order), one all-gather of the
per-expert counts gives the global demand and the counts of the ranks
before this one, and capacity, keep/drop and `load` are the global step's;
`imp` and `router_z` stay local means, which the step's row-weighted
average of the ranks' losses turns into the global means.  So a rank's
kept pairs, and the weighted loss and its gradients, are the global
step's up to rounding, drops included.  (Under gloo the all-gather stages
the counts through host memory, the one host sync of this path.)

Tensor parallelism (a `ShardCtx` with a live mesh).  The fused gate+up
weights (`FUSED_GATE_UP`: `wi`, `shared_wi`, each expert's `wi`) are
column-parallel in halves: a process holds its slice of gate beside its
slice of up (`interop.shard_params`), so the local split pairs them as
the unsharded split does; `wo` is row-parallel, its f32 partial sums
all-reduced, then cast.  Expert parallelism where `moe_specs` puts the
experts on the axis (e % 16 == 0, OLMoE) and they divide it: routing runs
whole and identically on every process (the router replicates), each
process fills only its experts' rows of the capacity buffer and runs K5
on its groups, and the combine's f32 partial sums (0 from other
processes' experts) are all-reduced before the cast.  Otherwise (the
`fax` branch, Qwen1.5-MoE's 60 experts) the expert hidden dim shards:
every process routes and fills the whole buffer, runs K5 on its slice of
the hidden dim and writes f32 partials, all-reduced before the combine.
With the batch split over 'data', routing is global over the data ranks
(`global_routing`'s counts exchange) and the aux losses are their means.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import (
    NO_SHARD,
    Part,
    PSpec,
    ShardCtx,
    dense_rows,
    gemm,
    grouped_gemm,
)
from repro_torch.parallel.collectives import note_collective

__all__ = ["FUSED_GATE_UP", "global_routing", "moe_block", "moe_specs", "swiglu",
           "swiglu_specs"]

_GROUP_SIZE = 1024  # tokens per dispatch group at scale (capacity scaling)
_EXACT_GROUP = 256  # groups this small route exactly (no capacity drops)
_ROW_ALIGN = 8  # capacity rounds up so row blocks tile the ragged grid

# Weights whose last dim is [gate | up] side by side: tensor parallelism
# gives each process its slice of both halves (`interop.shard_params`).
FUSED_GATE_UP = ("wi", "shared_wi")


def swiglu_specs(cfg, d_ff: int) -> Dict[str, PSpec]:
    d = cfg.d_model
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    return {
        "wi": PSpec((d, 2 * d_ff), ("embed", "mlp"), 0.02),  # fused gate+up
        "wo": PSpec((d_ff, d), ("mlp", "embed"), out_scale),
    }


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
           ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """SwiGLU of width cfg.d_ff; under a mesh `wi` holds this process's
    gate and up slices and `wo` its rows (column- then row-parallel)."""
    f, d, t = cfg.d_ff, x.shape[-1], x.shape[1]
    part = ctx.part("mlp", f)
    gate_up = gemm(x, p["wi"], cfg)
    # The fused dim's layout is the port's (gate and up halves, each cut
    # alike), checked where the hidden dim shards.
    gate_up = ctx.c(gate_up, ("batch", "seq", "mlp"), (None, t, 2 * f if part.count > 1 else None))
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    h = F.silu(gate) * up
    return dense_rows(h, p["wo"], cfg, ctx, part, ("batch", "seq", "embed"), (None, t, d))


def moe_specs(cfg) -> Dict[str, PSpec]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    # EP where the experts divide the production 'model' axis (16); else
    # the expert hidden dim shards, as in the reference.
    ep_divisible = e % 16 == 0
    eax = "experts" if ep_divisible else None
    fax = None if ep_divisible else "mlp"
    specs = {
        "router": PSpec((d, e), ("embed", None), 0.02, dtype=torch.float32),
        "wi": PSpec((e, d, 2 * f), (eax, "embed", fax), 0.02),
        "wo": PSpec((e, f, d), (eax, fax, "embed"), out_scale),
    }
    if cfg.num_shared_experts:
        # The reference's key order: parameters are drawn and carried over
        # from numpy in it.
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        specs["shared_wi"] = PSpec((d, 2 * fs), ("embed", "mlp"), 0.02)
        specs["shared_wo"] = PSpec((fs, d), ("mlp", "embed"), out_scale)
        specs["shared_gate"] = PSpec((d, 1), ("embed", None), 0.02)
    return specs


def _capacity(n: int, t: int, e: int, k: int, capacity_factor: float) -> int:
    """Per-expert row capacity: tokens notionally split into (n // s) groups
    of s = min(_GROUP_SIZE, ...), each granting cf * s * k / e slots —
    except small groups, which route exactly (cap = n, drop-free)."""
    s = min(_GROUP_SIZE, t) if t > 1 else min(_GROUP_SIZE, n)
    while n % s:
        s //= 2
    if s <= _EXACT_GROUP:
        return n
    return (n // s) * max(1, int(capacity_factor * s * k / e))


# (process group, global batch rows) while a data-parallel step routes the
# global batch, else None; set only by `train_step.make_train_step`, whose
# docstring says why it is process-wide.
_GLOBAL_ROUTING: Dict[str, Optional[tuple]] = {"on": None}


@contextlib.contextmanager
def global_routing(group, rows: int):
    """Within the block, moe_block routes as if the ranks of `group` held
    one batch of `rows` rows, each a contiguous slice in rank order (module
    docstring).  `group` None (one rank) changes nothing."""
    prev = _GLOBAL_ROUTING["on"]
    _GLOBAL_ROUTING["on"] = None if group is None else (group, rows)
    try:
        yield
    finally:
        _GLOBAL_ROUTING["on"] = prev


def _counts_before_and_total(counts: torch.Tensor, group):
    """(sum of the counts of the ranks before this one, sum over all ranks)
    of the (e,) per-expert counts, by one all-gather (staged through host
    memory for a CUDA tensor under gloo)."""
    staged = counts.is_cuda and dist.get_backend(group) == "gloo"
    mine = counts.cpu() if staged else counts
    n = dist.get_world_size(group)
    note_collective("all-gather", n * mine.numel() * mine.element_size(), n)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    allc = torch.stack(parts).to(counts.device)
    return allc[:dist.get_rank(group)].sum(0), allc.sum(0)


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) expert indices, as jax.lax.top_k: on ties the lower expert
    index comes first, which a stable descending sort keeps."""
    return torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]


def _expert_parts(cfg, ctx: ShardCtx) -> Tuple[Part, Part]:
    """(experts, expert hidden dim) `Part`s under ctx: `moe_specs` puts the
    experts on the 'experts' axis where e % 16 == 0, else the hidden dim
    on 'mlp'; either replicates where it does not divide the axis."""
    e, f = cfg.num_experts, cfg.moe_d_ff
    if e % 16 == 0:
        return ctx.part("experts", e), Part(0, f, 1, None)
    return Part(0, e, 1, None), ctx.part("mlp", f)


def moe_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, D)
    cfg,
    ctx: ShardCtx = NO_SHARD,
    *,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output, aux) with aux = {'lb_loss', 'router_z'}."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = b * t
    dev = x.device
    ep, fp = _expert_parts(cfg, ctx)

    xf = x.reshape(n, d)
    xf = ctx.c(xf, ("batch", "embed"), (None, d))
    logits = torch.matmul(xf.float(), p["router"].float())  # (n, e)
    probs = torch.softmax(logits, dim=-1)
    topi = _top_k(probs, k)
    topv = torch.gather(probs, 1, topi)
    topv = topv / topv.sum(dim=-1, keepdim=True)

    # Sort/segment permutation: rank each (token, choice) pair within its
    # expert (the stable sort keeps token order), keep the first `cap`, and
    # scatter kept tokens into the group-major capacity buffer.
    flat_e = topi.reshape(-1)  # (n*k,) expert id per pair, token-major
    flat_t = torch.arange(n * k, device=dev) // k  # token id per pair
    order = torch.argsort(flat_e, stable=True)  # pairs grouped by expert
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))  # (e,) demand per expert
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n * k, device=dev) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    glob, dp = _GLOBAL_ROUTING["on"], None
    if glob is None and ctx.axes_of("batch") is not None:
        # The batch rows split over 'data': route the global batch.
        from repro_torch.parallel.collectives import axis_group

        dp, ranks, _ = axis_group(ctx.mesh, ctx.axes_of("batch"))
        glob = (dp, b * ranks)
    if glob is None:
        n_all, counts_all = n, counts
        cap = room = _capacity(n, t, e, k, capacity_factor)
        keep = rank < cap
    else:
        group, global_rows = glob
        n_all = global_rows * t
        before, counts_all = _counts_before_and_total(counts, group)
        cap = _capacity(n_all, t, e, k, capacity_factor)
        # A pair is kept if its rank among all ranks' pairs of its expert
        # (the pairs of earlier ranks first) is below the capacity.
        room = torch.clamp(cap - before, min=0)  # (e,) slots left for this rank
        keep = rank < room[flat_e]
        cap = min(cap, n)  # the rows-per-group bound: at most n pairs a rank
    rpg = -(-cap // _ROW_ALIGN) * _ROW_ALIGN  # static rows-per-group bound
    rows = e * rpg
    gate = topv.reshape(-1) * keep.to(topv.dtype)
    dest = torch.where(keep, flat_e * rpg + rank, rows)  # rows => dropped

    sizes = torch.clamp(counts, max=room)
    group_offsets = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev), torch.cumsum(sizes, 0).to(torch.int32)]
    )
    if ep.count > 1:
        # Expert parallelism: this process's experts' rows of the buffer,
        # their offsets from its first row; other pairs are dropped here.
        lo, mine = ep.start * rpg, ep.size * rpg
        local = (dest >= lo) & (dest < lo + mine)
        dest = torch.where(local, dest - lo, mine)
        gate = gate * local.to(gate.dtype)
        group_offsets = group_offsets[ep.start:ep.start + ep.size + 1] - group_offsets[ep.start]
        rows = mine
    row_axis = "expert_rows" if ep.count > 1 else None

    # Dropped pairs land in one extra row past the buffer, sliced away (an
    # index of `rows` is out of range for a rows-long buffer; clipping it
    # would overwrite row rows - 1).
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((dest,), xf[flat_t])[:rows]
    buf = ctx.c(buf, (row_axis, "embed"), (e * rpg if ep.count > 1 else rows, d))

    gate_up = grouped_gemm(buf, group_offsets, p["wi"], cfg)  # (rows, 2f)
    gate_h, up_h = torch.chunk(gate_up, 2, dim=-1)
    h = F.silu(gate_h) * up_h
    if fp.count > 1:  # the hidden dim sharded: f32 partials, all-reduced
        ex_out = grouped_gemm(h, group_offsets, p["wo"], cfg, out_dtype=torch.float32)
        ex_out = ctx.c(ex_out, (None, "embed"), (rows, d), partial=fp).to(x.dtype)
    else:
        ex_out = grouped_gemm(h, group_offsets, p["wo"], cfg)  # (rows, d)
        ex_out = ctx.c(ex_out, (row_axis, "embed"), (e * rpg if ep.count > 1 else rows, d))

    # Combine: gather each pair's expert output back and weight by its gate
    # (dropped pairs carry gate 0, so the clipped gather never contributes);
    # under EP each process sums its experts' terms, all-reduced in f32.
    contrib = ex_out[torch.clamp(dest, 0, rows - 1)] * gate.to(x.dtype)[:, None]
    y = contrib.float().reshape(n, k, d).sum(dim=1)
    y = ctx.c(y, ("batch", "embed"), (None, d), partial=ep).to(x.dtype).reshape(b, t, d)

    if cfg.num_shared_experts:
        # The gate is an f32 GEMM (the router's numerics) through the planner.
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        sg = torch.sigmoid(gemm(xf.float(), p["shared_gate"].float(), cfg)).to(x.dtype)
        g_, u_ = torch.chunk(gemm(xf, p["shared_wi"], cfg), 2, dim=-1)
        shared = dense_rows(F.silu(g_) * u_, p["shared_wo"], cfg, ctx, ctx.part("mlp", fs),
                            ("batch", "embed"), (None, d))
        y = y + (shared * sg).reshape(b, t, d)

    # Switch load-balance + router z-loss (means over all tokens).
    load = counts_all.float() / n_all  # fraction routed per expert
    imp = probs.mean(dim=0)
    lb_loss = e * torch.sum(load * imp) / k
    router_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if dp is not None:  # the data ranks' means: their token means of imp and z
        from repro_torch.parallel.collectives import all_reduce

        lb_loss, router_z = all_reduce(torch.stack([lb_loss, router_z]), group=dp) / ranks
    return ctx.c(y, ("batch", "seq", "embed"), (None, t, d)), {"lb_loss": lb_loss,
                                                              "router_z": router_z}
