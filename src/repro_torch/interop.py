"""Parameters and train states carried between the JAX package and the port,
bit for bit.

`params_from_numpy(tree, device)` turns a nested dict of numpy arrays —
the reference's parameter tree after `jax.tree.map(np.asarray, params)`,
done by the caller — into the port's tensors, so both packages compute on
the same weights.  `train_state_from_numpy` does the same for a whole train
state (params, AdamW `m`/`v`/`count`, `step`), and `train_state_to_numpy`
goes back, so a port state can be handed to the reference;
`stack_ranks` stacks the data-parallel ranks' (1, *shape) residual slices
into the reference's (dp, *shape) layout.  `shard_params` cuts a full
parameter tree, or a whole train state, into this rank's blocks for
tensor parallelism, and `model_blocks` describes those blocks for
training under a 'model' axis: which parts every 'model' rank holds alike
(their gradients are shares, summed over the axis), the norm of a tree of
blocks, and the gather back to the global tree and the cut again
(checkpoints).  bfloat16 arrays arrive as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses; they travel as their 16-bit patterns
(`view(np.uint16)`) and are reinterpreted as `torch.bfloat16`.  Neither
`jax` nor `ml_dtypes` is imported here.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ModelBlocks", "model_blocks", "params_from_numpy", "shard_params", "stack_ranks",
           "train_state_from_numpy", "train_state_to_numpy"]


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy: the tensor owns it
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays (params, or any other tree) -> the same
    tree of tensors on `device` (cuda unless the caller names another)."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)

    return convert(tree)


def train_state_from_numpy(state: Any, device=None) -> Any:
    """The reference's train state {"params", "opt": {"m", "v", "count"},
    "step"} as numpy arrays -> the port's train state on `device`.  Raises
    ValueError for a tree of another layout, which `make_train_step` would
    only reject mid-step."""
    if (not isinstance(state, dict) or set(state) != {"params", "opt", "step"}
            or not isinstance(state["opt"], dict)
            or set(state["opt"]) != {"m", "v", "count"}):
        raise ValueError("not a train state {'params', 'opt': {'m', 'v', 'count'}, 'step'}")
    return params_from_numpy(state, device)


def train_state_to_numpy(state: Any) -> Any:
    """A port tree of tensors -> the same tree of numpy arrays.  bfloat16
    tensors come back as their uint16 bit patterns (the caller views them as
    its bfloat16 type, e.g. `ml_dtypes.bfloat16`)."""

    def convert(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().copy()

    return tree_map(convert, state)


def stack_ranks(trees) -> Any:
    """The ranks' trees of numpy arrays, in rank order, each leaf a (1,
    ...) slice (the compressed DP step's "err") -> one tree whose leaves
    are their concatenation on axis 0, the reference's (dp, ...) leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_ranks([t[k] for t in trees]) for k in first}
    return np.concatenate(trees, axis=0)


def _is_train_state(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"params", "opt", "step"}


def _params_like(fn: Callable, tree):
    """fn applied to each parameter-shaped subtree of `tree`: the tree
    itself, or a train state's params and AdamW moments (its count and
    step are the same on every rank and stay as they are)."""
    if not _is_train_state(tree):
        return fn(tree)
    opt = tree["opt"]
    return {"params": fn(tree["params"]),
            "opt": {"m": fn(opt["m"]), "v": fn(opt["v"]), "count": opt["count"]},
            "step": tree["step"]}


def _leaf_pieces(shape, axes, key, cfg, ctx):
    """`parallel.sharding.block_pieces` of one leaf as the model code
    under `ctx` reads it (`shard_params`' exceptions included)."""
    from repro_torch.models.moe import FUSED_GATE_UP
    from repro_torch.models.ssm import MAMBA_LAYOUT, mamba_segments
    from repro_torch.parallel.sharding import block_pieces

    rules, _, lay = ctx._resolved
    hd = cfg.head_dim_
    units = {"heads": (cfg.num_heads, hd), "kv_heads": (cfg.num_kv_heads, hd)}

    def segments(n):
        """[(kind, units, unit)] of a fused 'mlp' dim of n, or None."""
        if key in FUSED_GATE_UP:
            return [("heads", n // 2, 1)] * 2
        if cfg.family == "hybrid" and key in MAMBA_LAYOUT:
            return mamba_segments(cfg, key)
        return None

    fused = [a == "mlp" and segments(n) is not None for n, a in zip(shape, axes)]
    if not any(a in units for a in axes) and not any(fused):
        return block_pieces(shape, axes, ctx.mesh, rules, lay)

    def piece(off, part, unit):
        return (off + part.start * unit, part.size * unit, part.axes if part.count > 1 else None)

    out = []
    for d, (n, a) in enumerate(zip(shape, axes)):
        if a in units:
            count, unit = units[a]
            out.append((piece(0, ctx.part(a, count), unit),))
        elif fused[d]:
            pieces, off = [], 0
            for kind, count, unit in segments(n):
                pieces.append(piece(off, ctx.part(a, count), unit) if kind == "heads"
                              else (off, count * unit, None))
                off += count * unit
            out.append(tuple(pieces))
        elif a is not None:
            out.append((piece(0, ctx.part(a, n), 1),))
        else:
            out.append(((0, n, None),))
    return tuple(out)


def _cut(t: torch.Tensor, pieces) -> torch.Tensor:
    """The block of the global `t` that `pieces` describe, a new tensor."""
    for d, ps in enumerate(pieces):
        if len(ps) > 1:
            t = torch.cat([t.narrow(d, s, n) for s, n, _ in ps], dim=d)
        elif ps[0][1] != t.shape[d]:
            t = t.narrow(d, ps[0][0], ps[0][1])
    return t.contiguous().clone()


def _walk_specs(specs, fn, key=None):
    """fn(PSpec, its dict key) over a PSpec tree, as the same tree."""
    if isinstance(specs, dict):
        return {k: _walk_specs(v, fn, k) for k, v in specs.items()}
    return fn(specs, key)


def shard_params(params: Any, model, ctx) -> Any:
    """This rank's blocks of the full parameter tree `params` (from the
    reference's init through `params_from_numpy`, or the port's own), or
    of a whole train state (params and AdamW moments cut alike; the count
    and the step as they are), laid out as the model code under `ctx` (a
    `models.layers.ShardCtx`) reads them.

    Each leaf is `shard_of` its `tree_shardings(model.logical_axes(), mesh,
    rules)` sharding (indivisible dims replicated), with these exceptions,
    where the port's layout is not the flat split of the dim:
      * 'heads' and 'kv_heads' dims (h * hd, kv * hd) split in whole heads,
        and replicate unless the head count divides the axis;
      * a fused [gate | up] dim (`moe.FUSED_GATE_UP`) gives each rank its
        slice of gate beside its slice of up, so the model's local split
        pairs them (a flat split would give rank 0 all of gate);
      * Mamba2's 'mlp' dims (`ssm.MAMBA_LAYOUT`: in_proj's [z | x | B | C |
        dt], conv_w / conv_b's [x | B | C], out_norm and out_proj's x) give
        each rank its whole SSM heads of z, x and dt, and B and C whole.
    Under a ctx with `param_rules` (FSDP) the leaves are cut by those rules
    (`ShardCtx.params_ctx`): every 'embed' dim also over the DP axes.
    Without a live mesh the tree comes back as it is.
    """
    if not ctx.active:
        return params
    ctx = ctx.params_ctx()
    pieces = _walk_specs(model.specs(), lambda s, key: _leaf_pieces(s.shape, s.axes, key,
                                                                     model.cfg, ctx))
    return _params_like(lambda tree: tree_map(_cut, tree, pieces), params)


class ModelBlocks:
    """A rank's blocks of `model`'s parameter tree under `ctx`, as
    tensor-parallel training reads them (`model_blocks`).

    `replicated` is the tree of `parallel.sharding.replicated_ranges` of
    each leaf's block along 'model': True where every 'model' rank holds
    the whole leaf (norms, the router, kv heads that do not divide the
    axis, RWKV-6's per-channel parameters, which the model code slices
    itself), None where the block is this rank's own, and (dim, ranges)
    where a sharded block holds ranges every rank holds alike (Mamba2's B
    and C segments of in_proj, conv_w and conv_b).  A rank's gradient of a
    replicated part is its share (`parallel.collectives`), so
    `reduce_replicated` sums exactly those parts over 'model' and no
    others; `norm_squares` counts each sharded element on its own rank
    and each replicated one once.  `gather` and `cut` move between a tree
    (or a train state) of blocks and the global one.

    Under FSDP (a ctx with `param_rules`) the blocks are the parameter
    layout's: `data_cut` is the tree of each leaf's all-gathers over the
    DP axes (`parallel.sharding.fsdp_gathers`; empty for a leaf every DP
    rank holds whole).  A data-cut leaf's gradient arrives summed over the
    DP axes (the reduce-scatter of the model's per-layer gather), so the
    step all-reduces only the others over 'data'; `data_group` sums the
    data-cut leaves' norm squares there; `gather` joins the DP blocks
    before the 'model' ones."""

    def __init__(self, model, ctx):
        from repro_torch.parallel.collectives import axis_group
        from repro_torch.parallel.sharding import MeshLayout, fsdp_gathers, replicated_ranges

        self.model, self.ctx = model, ctx
        pctx = ctx.params_ctx()
        self.group, self.size, _ = axis_group(ctx.mesh, "model")
        specs = model.specs()
        self._shapes = _walk_specs(specs, lambda s, key: tuple(s.shape))
        self._pieces = _walk_specs(specs, lambda s, key: _leaf_pieces(s.shape, s.axes, key,
                                                                       model.cfg, pctx))
        self.replicated = tree_map(lambda ps: replicated_ranges(ps, "model"), self._pieces)
        rules, _, lay = ctx._resolved
        self.data_cut = _walk_specs(specs, lambda s, key: (
            fsdp_gathers(s.shape, s.axes, ctx.mesh, rules, ctx.param_rules) if ctx.fsdp
            else ()))
        axes = sorted({a for cuts in tree_leaves(self.data_cut) for _, ax in cuts
                       for a in ((ax,) if isinstance(ax, str) else ax)})
        self.data_group = axis_group(ctx.mesh, tuple(axes))[0] if axes else None
        # Every 'model' coordinate's pieces of the activation layout (the
        # blocks once joined over the DP axes), for `gather`.
        from repro_torch.models.layers import ShardCtx

        self._pieces_at = []
        for r in range(self.size):
            at = MeshLayout(lay.shape, {**lay.coord, "model": r}, lay.ranks)
            other = ShardCtx(ctx.mesh, ctx.rules, at)
            self._pieces_at.append(_walk_specs(
                specs, lambda s, key, c=other: _leaf_pieces(s.shape, s.axes, key, model.cfg, c)))

    def _parts(self, g: torch.Tensor, rep):
        """(own views, replicated views) of the block `g`."""
        if rep is True:
            return [], [g]
        if rep is None:
            return [g], []
        d, ranges = rep
        mine, off = [], 0
        for o, n in ranges:
            if o > off:
                mine.append(g.narrow(d, off, o - off))
            off = o + n
        if off < g.shape[d]:
            mine.append(g.narrow(d, off, g.shape[d] - off))
        return mine, [g.narrow(d, o, n) for o, n in ranges]

    @torch.no_grad()
    def reduce_replicated(self, grads: Any) -> Any:
        """Sums the replicated parts of every leaf of `grads` (a gradient
        tree of blocks, f32) over 'model', in place, by one f32 all-reduce
        of their concatenation; returns `grads`."""
        from repro_torch.parallel.collectives import all_reduce

        if self.group is None:
            return grads
        views = [v for g, rep in zip(tree_leaves(grads), tree_leaves(self.replicated))
                 for v in self._parts(g, rep)[1]]
        if views:
            flat = torch.cat([v.reshape(-1).float() for v in views])
            flat = all_reduce(flat, group=self.group)
            off = 0
            for v in views:
                v.copy_(flat[off:off + v.numel()].view(v.shape))
                off += v.numel()
        return grads

    def join_data(self, tree: Any) -> Any:
        """A tree of parameter-layout blocks (or a train state) with every
        data-cut leaf all-gathered over the DP axes: the blocks of the
        activation layout (without FSDP, `tree` itself)."""
        if self.data_group is None:
            return tree
        from repro_torch.parallel.collectives import all_gather, axis_group

        def one(blk, cuts):
            for d, axes in cuts:
                blk = all_gather(blk, d, axis_group(self.ctx.mesh, axes)[0])
            return blk

        return _params_like(lambda t: tree_map(one, t, self.data_cut), tree)

    def norm_squares(self, tree: Any, data_cut: Any = None):
        """(sum of squares of the elements this rank owns, sum of squares
        of the replicated ones) along 'model', each f32, in tree order; of
        the data-cut leaves only (`data_cut` True), the others (False) or
        every leaf (None)."""
        leaves = tree_leaves(tree)
        dev = leaves[0].device
        own = torch.zeros((), dtype=torch.float32, device=dev)
        rep = torch.zeros((), dtype=torch.float32, device=dev)
        cuts = tree_leaves(self.data_cut)
        for g, r, c in zip(leaves, tree_leaves(self.replicated), cuts):
            if data_cut is not None and bool(c) != data_cut:
                continue
            mine, same = self._parts(g, r)
            for v in mine:
                own = own + torch.sum(torch.square(v.float()))
            for v in same:
                rep = rep + torch.sum(torch.square(v.float()))
        return own, rep

    @torch.no_grad()
    def gather(self, tree: Any, device=None) -> Any:
        """The global tree (or train state) whose blocks the ranks hold, on
        every one of them (an all-gather over the DP axes of each data-cut
        leaf, then over 'model' of each sharded one), on `device` (by
        default each leaf's own)."""
        from repro_torch.parallel.collectives import all_gather

        tree = self.join_data(tree)

        def one(blk, shape, rep, *pieces_at):
            dev = blk.device if device is None else torch.device(device)
            if rep is True:
                return blk.to(dev, copy=True)
            d = next(i for i, ps in enumerate(pieces_at[0]) if len(ps) > 1 or ps[0][2])
            every = all_gather(blk, d, self.group).to(dev)
            out = torch.empty(shape, dtype=blk.dtype, device=dev)
            for r, pieces in enumerate(pieces_at):
                off = r * blk.shape[d]
                for start, size, _ in pieces[d]:
                    out.narrow(d, start, size).copy_(every.narrow(d, off, size))
                    off += size
            return out

        return _params_like(lambda t: tree_map(one, t, self._shapes, self.replicated,
                                               *self._pieces_at), tree)

    def cut(self, tree: Any) -> Any:
        """This rank's blocks of a global tree (or train state)."""
        return _params_like(lambda t: tree_map(_cut, t, self._pieces), tree)

    def global_like(self, tree: Any) -> Any:
        """A tree (or train state) shaped as the global one, of meta
        tensors in the dtypes of `tree`'s blocks (a checkpoint's `like`)."""
        return _params_like(lambda t: tree_map(
            lambda blk, shape: torch.empty(shape, dtype=blk.dtype, device="meta"),
            t, self._shapes), tree)


def model_blocks(model, ctx):
    """`ModelBlocks` of `model` under `ctx`, or None where ctx's 'model'
    axis has one rank and the parameters no layout of their own (every
    leaf whole: nothing to sum or gather)."""
    if ctx.axis_size("model") <= 1 and not ctx.fsdp:
        return None
    return ModelBlocks(model, ctx)
