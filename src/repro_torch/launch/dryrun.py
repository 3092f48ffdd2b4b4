"""Dry runs: one rank's step of every (arch x shape) cell on the production
meshes, traced without a card or any data (port of `repro.launch.dryrun`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/torch]

The reference lowers and compiles each cell's jitted step for 256 or 512
host devices and reads XLA's cost and memory analyses and the collectives
of the compiled HLO.  The port runs the step itself, as one rank of the
mesh, on meta tensors (shapes and dtypes, no storage):

  1. a "fake" default process group of the mesh's size is started with
     this process as rank 0 (`fake_group`), and `make_production_mesh`
     builds the 16 x 16 ('data', 'model') or 2 x 16 x 16 ('pod', 'data',
     'model') DeviceMesh over it: every collective returns at once and
     moves nothing;
  2. the rank's inputs (`build_step`): the train state or the parameters
     from the abstract tree (`abstract_train_state`,
     `Model.abstract_params`) cut to this rank's blocks by
     `interop.shard_params`; the global batch, which the port's steps take
     whole on every rank and cut to their rows (so the argument bytes hold
     it, where the reference's hold the rank's block); or the decode state
     of the rank's rows as `Model.decode_state_specs` lays it out under
     the cell's ctx, at its last position;
  3. the cell's entry point, the port's own `make_train_step(..., ctx=)`
     (forward and backward, clipping and AdamW), `make_prefill_step` or
     `make_serve_step`, runs once under `_Traffic`, a dispatch mode of
     this module, which counts the FLOPs, the bytes every non-view op
     reads and writes and the live storage, while
     `collectives.record_collectives` lists each collective the rank
     issues (`launch/hlo_stats.py` applies the ring multipliers);
  4. artifacts/torch/<mesh>/<arch>__<shape>.json is written in the
     reference's format, which `launch/roofline.py` reads.

Host reads inside the step would raise on meta tensors; the train
step's one host read, of its cross-rank failure flag, is left out on the
meta device (`collectives.raise_together`), while the flag's all-reduces
are issued and recorded as on the card.  The models and the
plans run on the meta device as on the card (`torch` backend plans;
K6's `_FlashAttention` with its plain forward), so the trace's structure,
saved tensors included, is the card's; the plans it makes are dropped
after it.

What the counts mean, against the reference's:
  * flops_per_device: products only, by the formulas of
    `torch.utils.flop_counter` (mm, bmm, addmm, baddbmm, convolutions,
    SDPA; `FlopCounterMode` over the same step counts the same), and here
    `repro_torch::gemm` (a formula registered below: 2 M K N, leading
    dims folded into M); its backward runs `torch.matmul`s, which count
    themselves.  XLA also counts elementwise ops, so the port's
    useful-FLOP ratio reads higher.
  * bytes_per_device: for each non-view op, the bytes of its tensor
    inputs plus its outputs: the eager, unfused traffic the port runs,
    the kernels' plain versions included (`_sdpa_chunked` in K6's place,
    the segment-masked bmm for K5).
  * memory_analysis: argument_size (the rank's state and inputs),
    temp_size (the peak of live storage the step allocates above the
    arguments), output_size (the outputs' storage), alias_size (outputs
    that are argument storage: the state AdamW updates in place) and
    generated_code_size (0).
  * lower_s is the trace's wall time; compile_s is 0 (eager torch
    compiles nothing).
  * The trace runs every layer and every time step, so its full-depth
    count is exact, where XLA counts a scanned loop's body once.  The
    probe (`probe_corrected_costs`, depths (2, 4), the `*_corrected`
    keys) is kept and computed the reference's way; its extrapolation
    equals the full-depth count for the families whose layers are alike
    and exceeds it by at most the tail's fraction of one segment for
    hybrid (Zamba2's 2-layer tail, counted as 1/3 of a segment).
  * The same trace already holds the WKV and SSD state traffic that
    `recurrence_traffic_analytic` adds to the reference's byte count: the
    artifact carries the analytic value as the reference's does, with
    `recurrence_bytes_in_trace: true`, and the port's
    `roofline.analyze_artifact` does not add it again.

Every layout of the reference's cells runs: the tuned train cells'
Megatron sequence parallelism ('seq_sp') with the FSDP parameter rules
(`PARAM_RULES`: the rank's state is its (data x model) block, and each
layer gathers its weights over 'data'), and the decode cells'
sequence-sharded KV caches ('kv_seq' on 'model' where the kv heads do
not divide it, on ('pod', 'data') for long_500k): the rank holds its block
of the cache's positions, and decode combines the ranks' partials
(`models.attention`).  `grad_accum` is the config's field, as the
reference's dry run reads it.

Skip rules: long_500k only for supports_long_context archs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.interop import shard_params
from repro_torch.kernels import api
from repro_torch.launch.hlo_stats import collective_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.parallel.collectives import record_collectives
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, mesh_layout, mesh_shape
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.train_step import (
    abstract_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["run_cell", "input_specs", "fake_group", "trace_step"]

DEFAULT_OUT = os.path.join("artifacts", "torch")


# --- FLOPs of the dense product op --------------------------------------------

if torch.ops.repro_torch.gemm not in flop_registry:
    @register_flop_formula(torch.ops.repro_torch.gemm)
    def _gemm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        """2 M K N of `repro_torch::gemm`: a's leading dims fold into M (a
        2-D b), or are the batch and M (a 3-D b)."""
        return 2 * math.prod(a_shape[:-1]) * a_shape[-1] * b_shape[-1]


# --- bytes and live storage of the traced step ----------------------------------


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat_tensors(args, kwargs):
    """The tensors among an op's arguments (flat, or in lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class _Unkeyed(Exception):
    pass


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _sig(x):
    """A hashable key of an op argument's metadata: what a meta kernel's
    output depends on."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type, x.requires_grad)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _Unkeyed


# Ops that return a view of their input without saying so in their schema
# (`reshape` of a tensor it must copy returns `_unsafe_view` of the copy).
_UNMARKED_VIEWS = frozenset({torch.ops.aten._unsafe_view.default})


def _is_view(func) -> bool:
    return func.is_view or func in _UNMARKED_VIEWS


def _fresh(func) -> bool:
    """`func` mutates nothing and returns new tensors (no alias of an
    input): its meta output depends only on its arguments' metadata."""
    s = func._schema
    return (not _is_view(func) and not s.is_mutable and bool(s.returns)
            and all(r.alias_info is None for r in s.returns)
            and all(str(r.type) in ("Tensor", "Tensor[]") for r in s.returns))


class _Traffic(TorchDispatchMode):
    """Counts, for each op the step dispatches: its FLOPs (the formulas of
    `torch.utils.flop_counter`, whose `FlopCounterMode` counts the same
    ops), the bytes of its tensor inputs plus its outputs (views and
    collectives excepted), and the storage its outputs hold, live from the
    op until the last tensor on it is freed (`weakref.finalize`).  Storage
    of the arguments (`known`) is the arguments' and is not counted
    again."""

    _SKIP = ("c10d", "_c10d_functional", "prim")

    def __init__(self, known):
        super().__init__()
        self.known = set(known)
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}
        self._fresh_ops: set = set()
        self._other_ops: set = set()
        self._composite: set = set()
        self._outs: Dict[tuple, tuple] = {}

    def _drop(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _run(self, func, args, kwargs):
        """func on meta tensors: a fresh op's output metadata is kept per
        argument metadata and rebuilt with `empty_strided` on a repeat (the
        meta kernels of elementwise ops run in Python and dominate a trace
        of the per-token WKV scan otherwise)."""
        try:
            key = ((func, _sig(args), _sig(tuple(kwargs.items())))
                   if func in self._fresh_ops else None)
        except _Unkeyed:
            key = None
        meta = self._outs.get(key) if key is not None else None
        if meta is not None:
            outs = [torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in meta[1]]
            return outs[0] if meta[0] else outs
        out = func(*args, **kwargs)
        if key is not None:
            single = isinstance(out, torch.Tensor)
            outs = [out] if single else list(out)
            if all(o.device.type == "meta" for o in outs):
                self._outs[key] = (single, [(tuple(o.shape), o.stride(), o.dtype) for o in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._fresh_ops and func not in self._other_ops:
            (self._fresh_ops if _fresh(func) else self._other_ops).add(func)
            if func.has_kernel_for_dispatch_key(torch._C.DispatchKey.CompositeImplicitAutograd):
                self._composite.add(func)
        if func in self._composite:
            # Without autograd (inference mode) composite ops (matmul, einsum)
            # arrive whole: count the ops they decompose into, as
            # FlopCounterMode does.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, args, kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else _flat_tensors(out or (), {})
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not _is_view(func) and func.namespace not in self._SKIP:
            self.bytes += sum(map(_nbytes, _flat_tensors(args, kwargs)))
            self.bytes += sum(map(_nbytes, outs))
        for t in outs:
            key = _key(t)
            if key in self.known:
                continue
            ref = self._refs.get(key)
            if ref is None:
                ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
                self.live += ref[0]
                if self.live > self.peak:
                    self.peak = self.live
            ref[1] += 1
            weakref.finalize(t, self._drop, key)
        return out


def _storage_bytes(tensors) -> Dict[int, int]:
    return {_key(t): t.untyped_storage().nbytes() for t in tensors}


# --- the process group ------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A "fake" default process group of `world` ranks with this process as
    `rank`, for the block (every collective returns at once, moving
    nothing); destroyed on the way out.  A fake group of that size that is
    already up is used as it is and left up; a group of another backend or
    size raises ValueError."""
    if dist.is_initialized():
        backend, size = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or size != world:
            raise ValueError(f"a {backend!r} process group of {size} ranks is up; the dry run"
                             f" needs a 'fake' group of {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _untimed():
    """No timed path inside a trace (`REPRO_COSTMODEL_TIMED` off), and no
    plan of the meta device outlives it (the cache keys plans by device
    type, so the CPU's and the card's plans are untouched)."""
    prev = os.environ.pop("REPRO_COSTMODEL_TIMED", None)
    try:
        yield
    finally:
        api.clear_plan_cache("meta")
        if prev is not None:
            os.environ["REPRO_COSTMODEL_TIMED"] = prev


# --- rules and inputs ---------------------------------------------------------------


def _rules_for(cfg, shape, mesh, tuned: bool = False) -> ShardingRules:
    """Per-cell sharding rules, the reference's.

    tuned=True layers on its tuned rules: Megatron-SP remat carriers for
    train, and sequence-parallel attention wherever heads don't divide TP.
    """
    rules = DEFAULT_RULES
    tp = mesh_shape(mesh).get("model", 1)
    if shape.kind in ("decode", "long_decode"):
        if cfg.num_kv_heads % tp:
            # GQA kv heads don't divide TP: shard the cache length instead (SP)
            rules = rules.replace(kv_heads=None, kv_seq="model")
    if shape.kind == "long_decode":
        # B=1: no batch sharding; stream the huge KV/state over DP axes too
        rules = rules.replace(batch=None, kv_batch=None, kv_seq=("pod", "data"))
        if cfg.num_kv_heads % tp == 0:
            rules = rules.replace(kv_heads="model")
    if tuned:
        if shape.kind == "train":
            rules = rules.replace(seq_sp="model")
        if shape.kind in ("train", "prefill") and cfg.num_heads % tp:
            rules = rules.replace(seq_attn="model")
    return rules


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of the cell's entry point."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = get_model(cfg)
    if shape.kind in ("train", "prefill"):
        batch, axes = model.batch_specs(shape)
        return {"batch": batch, "batch_axes": axes}
    tokens, state, pos, axes = model.decode_input_specs(shape)
    return {"tokens": tokens, "state": state, "pos": pos, "state_axes": axes}


def _cell_applicable(cfg, shape) -> Optional[str]:
    if shape.kind == "long_decode" and not cfg.supports_long_context:
        return (
            "N/A: pure full-attention arch — long_500k requires sub-quadratic "
            "attention (skip recorded per DESIGN.md §5)"
        )
    return None


def _last_pos(cfg, shape) -> int:
    """The decode step's position: the last of the state's cache, the step
    that reads all of it."""
    if cfg.family == "audio":
        return shape.seq_len // cfg.dec_ratio - 1
    if cfg.family == "vlm":
        return shape.seq_len + cfg.num_stub_patches - 1
    return shape.seq_len - 1


def _empty(t: torch.Tensor) -> torch.Tensor:
    """A tensor of t's shape and dtype on the meta device (no storage)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def build_step(cfg, shape, mesh, rules, param_rules=None,
               make: Callable[[torch.Tensor], torch.Tensor] = _empty):
    """The rank's step of the cell and its inputs: (step, args).  `make`
    turns each meta tensor of the rank's inputs into the tensor passed
    (by default a meta tensor; `chip_smoke.py` makes real ones on the
    card).

    param_rules: a separate layout of the parameters and optimizer state
    (the reference's FSDP `PARAM_RULES`: 'embed' also over the DP axes),
    the train step's `ShardCtx(param_rules=)`; activations keep `rules`."""
    model = get_model(cfg)
    ctx = ShardCtx(mesh, rules, param_rules=param_rules)

    if shape.kind == "train":
        state = tree_map(make, shard_params(abstract_train_state(model), model, ctx))
        batch = tree_map(make, model.batch_specs(shape)[0])
        step = make_train_step(model, warmup_cosine(3e-4, 100, 10_000), AdamWConfig(), ctx,
                               grad_accum=cfg.grad_accum)
        return step, (state, batch)
    if shape.kind == "prefill":
        params = tree_map(make, shard_params(model.abstract_params(), model, ctx))
        batch = tree_map(make, model.batch_specs(shape)[0])
        return make_prefill_step(model, ctx), (params, batch)
    # decode / long_decode: the decode state of this rank's rows
    b = shape.global_batch
    rows_ctx = ctx.for_rows(b)
    rows = rows_ctx.part("batch", b).size
    params = tree_map(make, shard_params(model.abstract_params(), model, ctx))
    tokens = make(model.decode_input_specs(shape)[0])
    dstate = {k: make(torch.empty(shp, dtype=dt, device="meta"))
              for k, (shp, dt) in model.decode_state_specs(rows, shape.seq_len,
                                                           rows_ctx).items()}
    return make_serve_step(model, ctx), (params, tokens, dstate, _last_pos(cfg, shape))


def trace_step(cfg, shape, mesh, rules, param_rules=None) -> Dict[str, Any]:
    """One run of the rank's step on meta tensors: its FLOPs, bytes, memory
    analysis and collectives (module docstring).  The mesh's process group
    must be up (`fake_group`)."""
    with _untimed():
        step, args = build_step(cfg, shape, mesh, rules, param_rules)
        arg_storage = _storage_bytes(_tensors(args))
        traffic = _Traffic(arg_storage)
        with record_collectives() as records, traffic:
            out = step(*args)
        out_storage = _storage_bytes(_tensors(out))
        del out, args, step
    alias = sum(n for k, n in out_storage.items() if k in arg_storage)
    coll = collective_stats(records)
    return {
        "flops": float(traffic.flops),
        "bytes": float(traffic.bytes),
        "coll_link_bytes": sum(s["link_bytes"] for s in coll.values()),
        "collectives": coll,
        "memory_analysis": {
            "argument_size_in_bytes": sum(arg_storage.values()),
            "output_size_in_bytes": sum(out_storage.values()),
            "temp_size_in_bytes": traffic.peak,
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": 0,
        },
    }


# --- cost probe ------------------------------------------------------------
# The reference's: XLA counts a while-loop body ONCE, so it compiles two
# reduced depths unrolled and extrapolates the per-layer slope.  The port's
# trace runs every layer, so its full-depth count needs no correction; the
# probe is kept, computed the same way, and agrees with it (module
# docstring).

PROBE_DEPTHS = (2, 4)


def _probe_cfg(cfg, k: int):
    if cfg.family == "hybrid":
        # depth unit = one (period x mamba + shared-attn) segment
        return dataclasses.replace(cfg, num_layers=k * cfg.shared_attn_period)
    if cfg.family == "audio":
        # enc and dec scale together (enc_layers == dec_layers for whisper)
        return dataclasses.replace(cfg, num_layers=k, enc_layers=k, dec_layers=k)
    return dataclasses.replace(cfg, num_layers=k)


def _full_depth_units(cfg) -> float:
    if cfg.family == "hybrid":
        # fractional tail segment approximates `tail` mamba layers (slightly
        # overcounts the shared block: 38 = 6*6 + 2 -> 6.33 units)
        return cfg.num_layers / cfg.shared_attn_period
    if cfg.family == "audio":
        return float(cfg.enc_layers)
    return float(cfg.num_layers)


def probe_corrected_costs(cfg, shape, mesh, rules, param_rules=None) -> Dict[str, Any]:
    """Two reduced-depth traces -> per-layer slope -> full-depth cost."""
    k1, k2 = PROBE_DEPTHS
    c1 = trace_step(_probe_cfg(cfg, k1), shape, mesh, rules, param_rules)
    c2 = trace_step(_probe_cfg(cfg, k2), shape, mesh, rules, param_rules)
    full = _full_depth_units(cfg)
    out: Dict[str, Any] = {"probe_depths": [k1, k2], "full_depth_units": full}
    # The reference also multiplies by cfg.grad_accum: XLA counts the
    # microbatch scan's body once.  The port's trace runs every microbatch,
    # as it runs every layer, so the same quantity (the whole step's cost)
    # takes no such factor here.
    for key in ("flops", "bytes", "coll_link_bytes"):
        slope = (c2[key] - c1[key]) / (k2 - k1)
        out[key] = c1[key] + max(0.0, full - k1) * slope
        out[key + "_per_unit"] = slope
    return out


def recurrence_traffic_analytic(cfg, shape, mesh, rules) -> float:
    """HBM bytes/device of sequential recurrent-state updates, the
    reference's analytic count (which its cost analysis cannot see; the
    port's trace already holds them: module docstring).

    rwkv6 (ssm): the faithful WKV scan carries a (B_loc, H, K, V) f32 state
    through T per-token steps per layer -> L*T*2*state_bytes (x3 for train:
    fwd + remat-recompute + bwd state grads).
    zamba2 (hybrid): SSD is chunk-parallel; only the inter-chunk carry scan is
    sequential -> L*(T/chunk)*2*state_bytes.
    Transformer families: no sequential recurrence -> 0.
    """
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    # local batch after sharding ('batch' -> DP axes unless rules dropped it)
    phys = rules.get("batch")
    shape_of = mesh_shape(mesh)
    dp = 1
    if phys is not None:
        for a in (phys,) if isinstance(phys, str) else phys:
            dp *= shape_of.get(a, 1)
    b_loc = max(1, shape.global_batch // dp)
    t_len = shape.seq_len if shape.kind in ("train", "prefill") else 1
    train_mult = 3.0 if shape.kind == "train" else 1.0
    if cfg.family == "ssm":
        h, hd = cfg.num_heads, cfg.head_dim_
        state_bytes = b_loc * h * hd * hd * 4
        if getattr(cfg, "wkv_chunked", False) and t_len > 1:
            # chunk-parallel WKV (models/rwkv._wkv_chunked): per chunk, the
            # state is touched twice and the (C, C, K) decay tensor + (C, C)
            # attention block are materialized once each (r+w).
            c = cfg.wkv_chunk
            nc = max(1, t_len // c)
            d_block = b_loc * c * c * h * hd * 4  # exp(diff) tensor, f32
            a_block = b_loc * c * c * h * 4
            per_chunk = 2 * state_bytes + 2 * (d_block + a_block)
            return float(cfg.num_layers * nc * per_chunk * train_mult)
        steps = t_len
    else:
        d_in = cfg.ssm_expand * cfg.d_model
        state_bytes = b_loc * d_in * cfg.ssm_state_size * 4
        steps = max(1, t_len // 128)  # ssm.py _CHUNK
    return float(cfg.num_layers * steps * 2 * state_bytes * train_mult)


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules_override: Optional[ShardingRules] = None,
    param_rules: Optional[ShardingRules] = None,
    remat: Optional[str] = None,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    tuned: bool = False,
    probe: bool = True,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell as rank 0; returns the artifact
    dict.  Starts the fake group of the mesh's size unless it is up."""
    cfg = get_config(arch)
    if tuned:
        cfg = cfg.tuned()
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    skip = _cell_applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    art: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
    }
    if skip:
        art["status"] = "skipped"
        art["reason"] = skip
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: SKIP ({skip})")
        return art

    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = dist.get_world_size()
        rules = rules_override or _rules_for(cfg, shape, mesh, tuned=tuned)
        if tuned and param_rules is None and shape.kind == "train":
            from repro_torch.parallel.sharding import PARAM_RULES

            param_rules = PARAM_RULES  # FSDP params+opt, the reference's tuned layout
        model = get_model(cfg)

        t0 = time.monotonic()
        cost = trace_step(cfg, shape, mesh, rules, param_rules)
        t_trace = time.monotonic() - t0
        coll = cost["collectives"]
        art.update(
            status="ok",
            n_devices=n_dev,
            lower_s=round(t_trace, 2),
            compile_s=0.0,
            flops_per_device=cost["flops"],
            bytes_per_device=cost["bytes"],
            memory_analysis=cost["memory_analysis"],
            collectives=coll,
            collective_link_bytes=cost["coll_link_bytes"],
            n_params=model_param_count(model),
            n_active_params=cfg.n_active_params(),
            tokens_per_step=shape.global_batch
            * (shape.seq_len if shape.kind in ("train", "prefill") else 1),
        )
        if probe:
            t0 = time.monotonic()
            pr = probe_corrected_costs(cfg, shape, mesh, rules, param_rules)
            art["probe"] = pr
            art["flops_per_device_corrected"] = pr["flops"]
            art["bytes_per_device_corrected"] = pr["bytes"]
            art["collective_link_bytes_corrected"] = pr["coll_link_bytes"]
            art["recurrence_bytes_analytic"] = recurrence_traffic_analytic(
                cfg, shape, mesh, rules
            )
            art["recurrence_bytes_in_trace"] = True
            art["probe_s"] = round(time.monotonic() - t0, 2)
    if verbose:
        ma = art["memory_analysis"]
        print(
            f"[{mesh_name}] {arch} x {shape_name}: OK "
            f"trace={t_trace:.1f}s flops/dev={art['flops_per_device']:.3e} "
            f"bytes/dev={art['bytes_per_device']:.3e} "
            f"args/dev={ma.get('argument_size_in_bytes', 0)/2**30:.2f}GiB "
            f"temp/dev={ma.get('temp_size_in_bytes', 0)/2**30:.2f}GiB "
            f"coll_link_bytes/dev={art['collective_link_bytes']:.3e}"
        )
        print(f"  memory_analysis: {ma}")
        print(f"  collectives: { {k: int(v['count']) for k, v in coll.items()} }")
    return art


def model_param_count(model) -> int:
    return int(sum(math.prod(t.shape) for t in tree_leaves(model.abstract_params())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tuned", action="store_true",
                    help="cfg.tuned() and the reference's SP/seq_attn/FSDP rules")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    t_all = time.monotonic()
    for multi_pod in meshes:
        mesh_name = _mesh_name(multi_pod)
        os.makedirs(os.path.join(args.out, mesh_name), exist_ok=True)
        for arch, shape in cells:
            path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[{mesh_name}] {arch} x {shape}: exists, skip")
                continue
            try:
                # probe corrects cost terms for the (single-pod) roofline table;
                # multi-pod cells only validate the layout -> skip probe.
                art = run_cell(
                    arch, shape, multi_pod=multi_pod, remat=args.remat,
                    tuned=args.tuned, probe=not multi_pod,
                )
            except Exception as e:  # noqa: BLE001 - the cell's artifact records it
                traceback.print_exc()
                art = {
                    "arch": arch,
                    "shape": shape,
                    "mesh": mesh_name,
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                }
                failures.append((mesh_name, arch, shape))
            with open(path, "w") as f:
                json.dump(art, f, indent=1)
    print(f"\nwall {time.monotonic() - t_all:.1f} s for {len(cells) * len(meshes)} cells")
    if failures:
        print(f"\nFAILED cells ({len(failures)}):")
        for f3 in failures:
            print("  ", *f3)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
