"""The port's dry runs against the reference's functions
(`repro_torch.launch.dryrun`, `launch.hlo_stats`, `launch.roofline`'s
artifact half, the abstract specs they read).

In this process: `SHAPES`, `ASSIGNED_ARCHS` and `supports_long_context`;
the abstract parameter, train-state, batch and decode-input trees of every
config at full size against the reference's `ShapeDtypeStruct` trees
(shapes, dtypes, logical axes); `_rules_for`, `_cell_applicable` and
`recurrence_traffic_analytic` on all 40 cells and both meshes (a stand-in
mesh with a `.shape` dict: the reference reads only that); `model_flops`,
`analyze_artifact` (at equal constants) and `render_markdown` on the same
artifacts; `hlo_stats.collective_stats` of (kind, bytes, n) records
against the reference's parse of HLO lines made from them; one dense
step's FLOPs against the hand count of its products on one rank.

In one subprocess (a "fake" process group is process-wide state): the
collectives' records on a 4 x 2 mesh; a group over two mesh axes; the probe's extrapolation against
the full-depth trace (dense exactly, hybrid within its tail); `run_cell`
on the production mesh with a reduced config (an ok artifact, the group
destroyed after it); a `--tuned` train cell through the CLI ('seq_sp'
and FSDP: status "ok", its carrier gathers, FSDP-sized state); the
carrier a rank's `full` remat saves under 'seq_sp' (its sequence block);
and one full-width cell on pod16x16 at probe depth 2 (a sequence-sharded
cache).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ASSIGNED_ARCHS, CONFIGS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats, roofline  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.train_step import abstract_train_state  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(CONFIGS)
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules.  Its dryrun sets XLA_FLAGS at import for
    512 host devices; the variable is restored at once, so no later JAX
    backend in this process sees it."""
    pytest.importorskip("jax")
    import importlib

    prev = os.environ.get("XLA_FLAGS")
    try:
        mods = {name: importlib.import_module("repro." + name)
                for name in ("configs", "launch.dryrun", "launch.hlo_stats", "launch.roofline",
                             "models", "train.train_step")}
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mods


class _Mesh:
    """The reference's mesh as its dry-run arithmetic reads it."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _meta(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _flat(tree).items()}


def _struct(tree):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(tree).items()}


# -- configs ---------------------------------------------------------------------------


def test_shapes_and_assigned_archs_are_the_reference(ref):
    rc = ref["configs"]
    assert ASSIGNED_ARCHS == rc.ASSIGNED_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rc.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_long_context_is_the_reference(ref, arch):
    assert get_config(arch).supports_long_context == \
        ref["configs"].get_config(arch).supports_long_context


# -- abstract specs --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_train_state_are_the_reference(ref, arch):
    """Full size: every leaf's path, shape and dtype, on the meta device."""
    model = get_model(get_config(arch))
    rmodel = ref["models"].get_model(ref["configs"].get_config(arch))
    params = model.abstract_params()
    assert all(t.device.type == "meta" for t in _flat(params).values())
    assert _meta(params) == _struct(rmodel.abstract_params())
    state = abstract_train_state(model)
    assert _meta(state) == _struct(ref["train.train_step"].abstract_train_state(rmodel))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batch_and_decode_input_specs_are_the_reference(ref, arch, shape):
    model = get_model(get_config(arch))
    rmodel = ref["models"].get_model(ref["configs"].get_config(arch))
    sh, rsh = SHAPES[shape], ref["configs"].SHAPES[shape]
    if sh.kind in ("train", "prefill"):
        specs, axes = model.batch_specs(sh)
        rspecs, raxes = rmodel.batch_specs(rsh)
        assert _meta(specs) == _struct(rspecs)
        assert axes == raxes
        return
    tokens, state, pos, axes = model.decode_input_specs(sh)
    rtokens, rstate, rpos, raxes = rmodel.decode_input_specs(rsh)
    assert _meta({"t": tokens, "p": pos}) == _struct({"t": rtokens, "p": rpos})
    assert _meta(state) == _struct(rstate)
    assert axes == raxes


# -- the dry run's arithmetic ----------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_rules_and_recurrence_traffic_are_the_reference(ref, arch, shape):
    """`_cell_applicable` on all 40 cells; `_rules_for` (untuned and tuned)
    and `recurrence_traffic_analytic` on both meshes, bitwise; the tuned
    config (chunked WKV) too."""
    rd = ref["launch.dryrun"]
    for tuned in (False, True):
        cfg, rcfg = get_config(arch), ref["configs"].get_config(arch)
        if tuned:
            cfg, rcfg = cfg.tuned(), rcfg.tuned()
        sh, rsh = SHAPES[shape], ref["configs"].SHAPES[shape]
        assert dryrun._cell_applicable(cfg, sh) == rd._cell_applicable(rcfg, rsh)
        for dims in MESHES.values():
            mesh = _Mesh(dims)
            rules = dryrun._rules_for(cfg, sh, mesh, tuned=tuned)
            rrules = rd._rules_for(rcfg, rsh, mesh, tuned=tuned)
            assert dict(rules.table) == dict(rrules.table)
            got = dryrun.recurrence_traffic_analytic(cfg, sh, mesh, rules)
            want = rd.recurrence_traffic_analytic(rcfg, rsh, mesh, rrules)
            assert got == want and type(got) is type(want)


def _artifacts():
    """Artifacts in the shared format: one of each kind, a multi-pod cell,
    one without tokens_per_step, a skip and an error."""
    base = dict(status="ok", n_devices=256, mesh="pod16x16", memory_analysis={},
                collectives={}, n_params=8_000_000_000, n_active_params=7_000_000_000)
    return [
        dict(base, arch="granite-3-8b", shape="train_4k", kind="train",
             flops_per_device=4.4e14, bytes_per_device=1.1e13, collective_link_bytes=4.1e11,
             flops_per_device_corrected=4.5e14, bytes_per_device_corrected=1.2e13,
             collective_link_bytes_corrected=4.2e11, recurrence_bytes_analytic=0.0,
             tokens_per_step=1_048_576),
        dict(base, arch="rwkv6-1.6b", shape="prefill_32k", kind="prefill",
             flops_per_device=2.0e13, bytes_per_device=3.0e12, collective_link_bytes=1.0e9,
             recurrence_bytes_analytic=5.0e11, tokens_per_step=1_048_576),
        dict(base, arch="olmoe-1b-7b", shape="decode_32k", kind="decode", n_devices=512,
             mesh="pod2x16x16", flops_per_device=3.0e9, bytes_per_device=2.0e10,
             collective_link_bytes=9.0e9),
        dict(base, arch="zamba2-1.2b", shape="long_500k", kind="long_decode",
             flops_per_device=1.0e6, bytes_per_device=1.0e4, collective_link_bytes=0.0,
             tokens_per_step=1),
        {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "pod16x16", "kind": "long_decode",
         "status": "skipped", "reason": "N/A: pure full-attention arch — long_500k requires"},
        {"arch": "granite-3-8b", "shape": "train_4k", "mesh": "pod16x16", "status": "error",
         "error": "NotImplementedError: the 'seq_sp' rule"},
    ]


def test_roofline_over_artifacts_is_the_reference(ref, monkeypatch, tmp_path):
    rr = ref["launch.roofline"]
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(rr, name))
    arts = _artifacts()

    def unhinted(row, hints=None):
        """The row without its hint, whose wording is the port's (links,
        not ICI; tiles, not per-chip tiles)."""
        if row is None or row.get("skip"):
            return row
        assert hints is None or row["hint"] == hints[row["dominant"]]
        return {k: v for k, v in row.items() if k != "hint"}

    for art in arts:
        assert unhinted(roofline.analyze_artifact(art), roofline._HINTS) == \
            unhinted(rr.analyze_artifact(art))
        if art["status"] == "ok":
            assert roofline.model_flops(art) == rr.model_flops(art)
    for i, art in enumerate(arts):
        (tmp_path / f"{i}.json").write_text(json.dumps(art))
    rows = roofline.analyze_dir(str(tmp_path))
    assert [unhinted(r, roofline._HINTS) for r in rows] == \
        [unhinted(r) for r in rr.analyze_dir(str(tmp_path))]
    assert roofline.render_markdown(rows, "t") == rr.render_markdown(rows, "t")
    # The port's artifacts say that the trace holds the recurrent-state
    # traffic: it is not added again.
    mine = dict(arts[1], recurrence_bytes_in_trace=True)
    assert roofline.analyze_artifact(mine)["t_memory_s"] == 3.0e12 / roofline.HBM_BW


def _hlo_line(i, kind, nbytes, n):
    """One HLO op line of `kind` whose result has `nbytes` (f32) over a
    replica group of n, as the reference's parser reads them."""
    shape = f"f32[{nbytes // 4}]{{0}}"
    if kind == "collective-permute":
        pairs = ",".join(f"{{{s},{(s + 1) % n}}}" for s in range(n))
        return f"%cp.{i} = {shape} collective-permute({shape} %x), source_target_pairs={{{pairs}}}"
    groups = "{{" + ",".join(map(str, range(n))) + "}}"
    return f"%{kind}.{i} = {shape} {kind}({shape} %x), replica_groups={groups}"


def test_collective_stats_are_the_references_parse(ref):
    records = [("all-reduce", 4096, 16), ("all-reduce", 64, 2), ("all-gather", 65536, 16),
               ("all-gather", 1024, 256), ("collective-permute", 2048, 4),
               ("reduce-scatter", 8192, 16), ("all-to-all", 4096, 8), ("all-reduce", 4, 1)]
    hlo = "\n".join(_hlo_line(i, *r) for i, r in enumerate(records))
    want = ref["launch.hlo_stats"].collective_stats(hlo)
    got = hlo_stats.collective_stats(records)
    assert set(got) == set(want)
    for kind in want:
        assert got[kind]["count"] == want[kind]["count"]
        assert got[kind]["payload_bytes"] == want[kind]["payload_bytes"]
        assert got[kind]["link_bytes"] == pytest.approx(want[kind]["link_bytes"], rel=1e-12)
    with pytest.raises(ValueError, match="unknown collective"):
        hlo_stats.link_bytes("broadcast", 8, 2)


# -- one rank's step against the hand count ------------------------------------------------


def _dense_products(cfg, b, t) -> int:
    """FLOPs of one dense train step's products, by hand: per layer the q,
    k, v, o projections, QK^T and PV over the whole (masked) square, the
    SwiGLU's two products, then the head; the backward takes two products
    of each (no remat: remat_policy none)."""
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                          cfg.d_ff, cfg.vocab_size)
    tok = b * t
    proj = 2 * tok * d * (h * hd + 2 * kv * hd) + 2 * tok * h * hd * d
    attn = 2 * 2 * b * h * t * t * hd
    mlp = 2 * tok * d * 2 * f + 2 * tok * f * d
    head = 2 * tok * d * v
    return 3 * (cfg.num_layers * (proj + attn + mlp) + head)


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-7b"])
def test_one_rank_dense_step_flops_are_the_hand_count(arch):
    """One rank (a mesh of 1 x 1, no process group): `repro_torch::gemm`
    counts through its registered formula and its backward's matmuls count
    themselves, once each; FlopCounterMode, run over the same step, agrees."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(get_config(arch).reduced(), remat_policy="none",
                              param_dtype="bfloat16", activation_dtype="bfloat16")
    shape = ShapeSpec("t", 32, 4, "train")
    mesh = make_local_mesh((1, 1), ("data", "model"))
    rules = dryrun._rules_for(cfg, shape, mesh)
    got = dryrun.trace_step(cfg, shape, mesh, rules)
    assert got["flops"] == _dense_products(cfg, 4, 32)
    assert got["collectives"] == {}
    step, args = dryrun.build_step(cfg, shape, mesh, rules)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert fc.get_total_flops() == got["flops"]
    ma = got["memory_analysis"]
    assert ma["alias_size_in_bytes"] > 0 and ma["temp_size_in_bytes"] > 0
    assert ma["argument_size_in_bytes"] >= ma["alias_size_in_bytes"]


def test_dense_step_counts_scale_with_the_batch():
    """Twice the rows: the products' FLOPs double (the weights' traffic
    does not, so bytes grow by less)."""
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), remat_policy="none")
    mesh = make_local_mesh((1, 1), ("data", "model"))
    one, two = (dryrun.trace_step(cfg, ShapeSpec("t", 32, b, "train"), mesh,
                                  dryrun._rules_for(cfg, ShapeSpec("t", 32, b, "train"), mesh))
                for b in (2, 4))
    assert two["flops"] == 2 * one["flops"]
    assert one["bytes"] < two["bytes"] < 2 * one["bytes"]


# -- fake process groups, in one subprocess --------------------------------------------------

_SCRIPT = r"""
import dataclasses, json, math, sys, tempfile
import torch, torch.distributed as dist
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.parallel import collectives as col

out = {}
with dryrun.fake_group(8):
    mesh = make_local_mesh((4, 2), ("data", "model"))
    g = mesh.get_group("data")
    x = torch.empty(6, 8, device="meta")
    with col.record_collectives() as rec:
        col.all_reduce(x, group=g)
        col.all_gather(x, 0, g)
        col.reduce_scatter(x.new_empty(8, 8), 0, g)
        col._ppermute(torch.empty(6, 8), [0, 2, 4, 6], 0, col._shift(4, 1))  # P2P: no meta
    out["records"] = rec
out["group_after_records"] = dist.is_initialized()
with dryrun.fake_group(8, rank=5):
    mesh = make_local_mesh((2, 2, 2), ("pod", "data", "model"))
    g, n, idx = col.axis_group(mesh, ("pod", "data"))
    out["flat"] = [n, idx, dist.get_process_group_ranks(g), dist.get_rank(g),
                   col.axis_group(mesh, ("pod", "data"))[0] is g]
with dryrun.fake_group(8):
    mesh = make_local_mesh((4, 2), ("data", "model"))
    shape = ShapeSpec("t", 64, 8, "train")
    for arch, layers in (("granite-3-8b", 6), ("zamba2-1.2b", 7)):
        cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
        rules = dryrun._rules_for(cfg, shape, mesh)
        full = dryrun.trace_step(cfg, shape, mesh, rules)
        pr = dryrun.probe_corrected_costs(cfg, shape, mesh, rules)
        out["probe", arch] = {k: [pr[k], full[k], pr[k + "_per_unit"]]
                              for k in ("flops", "bytes", "coll_link_bytes")}
        out["units", arch] = pr["full_depth_units"]
out["group_after_small"] = dist.is_initialized()

red = get_config("granite-3-8b").reduced()
over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
        if f.name not in ("arch_id", "source")}
art = dryrun.run_cell("granite-3-8b", "train_4k", cfg_overrides=over, verbose=False)
out["run_cell"] = art
out["group_after"] = dist.is_initialized()
tmp = tempfile.mkdtemp()
try:
    dryrun.main(["--arch", "granite-3-8b", "--shape", "train_4k", "--tuned", "--out", tmp])
    out["main_exit"] = 0
except SystemExit as e:
    out["main_exit"] = e.code
out["tuned"] = json.load(open(f"{tmp}/pod16x16/granite-3-8b__train_4k.json"))
out["group_after_main"] = dist.is_initialized()

# A rank's saved carrier under 'seq_sp' on 'model' (2 ranks) and `full`
# remat: the checkpointed layers' input is its (rows, T/2, D) block.
from repro_torch.models import transformer
from repro_torch.parallel.sharding import PARAM_RULES, TRAIN_RULES
saved, run = [], transformer.checkpoint
def spy(fn, *args, **kw):
    saved.append(list(args[0].shape))
    return run(fn, *args, **kw)
transformer.checkpoint = spy
with dryrun.fake_group(8):
    mesh = make_local_mesh((4, 2), ("data", "model"))
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), remat_policy="full")
    dryrun.trace_step(cfg, ShapeSpec("t", 64, 8, "train"), mesh, TRAIN_RULES, PARAM_RULES)
transformer.checkpoint = run
out["seq_sp_saved"] = saved
out["seq_sp_want"] = [[2, 32, cfg.d_model]] * cfg.num_layers

with dryrun.fake_group(256):
    mesh = make_production_mesh()
    cfg = dryrun._probe_cfg(get_config("qwen2-7b"), 2)
    sh = SHAPES["decode_32k"]
    out["full_width"] = dryrun.trace_step(cfg, sh, mesh, dryrun._rules_for(cfg, sh, mesh))
print("RESULT " + json.dumps({json.dumps(k) if isinstance(k, tuple) else k: v
                              for k, v in out.items()}))
"""


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONWARNINGS="ignore")
    env.pop("REPRO_COSTMODEL_TIMED", None)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(s for s in res.stdout.splitlines() if s.startswith("RESULT "))
    got = json.loads(line[len("RESULT "):])
    return {tuple(json.loads(k)) if k.startswith("[") else k: v for k, v in got.items()}


def test_collectives_record_what_the_rank_issues(ranks):
    """An all-reduce of its payload, an all-gather of its gathered result,
    `reduce_scatter` as the all-reduce it issues, a ring hop as a
    collective-permute; each with its group's size."""
    assert [tuple(r) for r in ranks["records"]] == [
        ("all-reduce", 6 * 8 * 4, 4), ("all-gather", 4 * 6 * 8 * 4, 4),
        ("all-reduce", 8 * 8 * 4, 4), ("collective-permute", 6 * 8 * 4, 4)]


def test_a_group_over_two_mesh_axes_is_their_flattened_group(ranks):
    """('pod', 'data') of a 2 x 2 x 2 mesh, as rank 5 (pod 1, data 0,
    model 1): the ranks of its 'model' coordinate in row-major order, and
    this rank's index in them, made once."""
    assert ranks["flat"] == [4, 2, [1, 3, 5, 7], 2, True]
    assert not ranks["group_after_records"]


def test_probe_extrapolates_to_the_full_depth_trace(ranks):
    """Dense: the probe at depths (2, 4) equals the 6-layer trace exactly.
    Hybrid (7 layers, period 2: 3.5 units, a 1-layer tail): the probe
    counts the tail as half a segment, shared attention block included, so
    it exceeds the trace by at most half a segment's slope."""
    assert ranks["units", "granite-3-8b"] == 6.0
    for key, (probe, full, _) in ranks["probe", "granite-3-8b"].items():
        assert probe == full, key
    assert ranks["units", "zamba2-1.2b"] == 3.5
    for key, (probe, full, slope) in ranks["probe", "zamba2-1.2b"].items():
        assert 0 <= probe - full <= 0.5 * slope, key


def test_run_cell_writes_an_ok_artifact_and_destroys_its_group(ranks):
    art = ranks["run_cell"]
    assert art["status"] == "ok" and art["n_devices"] == 256 and art["mesh"] == "pod16x16"
    for key in ("flops_per_device", "bytes_per_device", "collective_link_bytes",
                "flops_per_device_corrected", "bytes_per_device_corrected"):
        assert math.isfinite(art[key]) and art[key] > 0, key
    assert art["recurrence_bytes_in_trace"] is True
    assert set(art["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "generated_code_size_in_bytes"}
    assert art["tokens_per_step"] == 256 * 4096
    assert not ranks["group_after_small"]
    assert not ranks["group_after"] and not ranks["group_after_main"]
    assert roofline.analyze_artifact(art)["dominant"] in ("compute", "memory", "collective")


def test_tuned_train_cell_is_the_seq_sp_error(ranks):
    """The `--tuned` train cell (once the 'seq_sp' refusal) lowers: 'seq_sp'
    on 'model' with the FSDP parameter rules.  Each of the 40 layers
    all-gathers its carrier in the forward and again in the `dots`
    recompute, beside its weights' FSDP gathers; their reduce-scatters are
    recorded as the all-reduces they issue; the rank's state is its (data
    x model) block: within 2x of 10 bytes a parameter (bf16, f32 m and v)
    over 256 ranks, where 'model' alone would leave 16x that."""
    art = ranks["tuned"]
    assert ranks["main_exit"] == 0
    assert art["status"] == "ok" and art["n_devices"] == 256
    layers = get_config("granite-3-8b").num_layers
    coll = art["collectives"]
    assert coll["all-gather"]["count"] >= 2 * layers
    assert coll["all-reduce"]["count"] >= 2 * layers
    fsdp = art["n_params"] * 10 / 256
    batch = 2 * 256 * 4096 * 4  # tokens and labels, int32, whole on every rank
    assert art["memory_analysis"]["argument_size_in_bytes"] <= 2 * fsdp + batch
    assert ranks["seq_sp_saved"] == ranks["seq_sp_want"]


def test_full_width_cell_at_probe_depth_on_pod16x16(ranks):
    """Qwen2-7B decode_32k at 2 layers and full width as rank 0 of 256:
    its 4 kv heads replicate over 'model', which cuts the cache's length
    instead ('kv_seq'), 8 of the 128 rows: the rank holds 1/16 of each
    row's positions, and combines its partials with the other 15."""
    c = ranks["full_width"]
    assert all(math.isfinite(c[k]) and c[k] > 0 for k in ("flops", "bytes", "coll_link_bytes"))
    cache = 2 * 2 * 8 * 32768 * 4 * 128 * 2  # k and v, layers, rows, len, kv, hd, bf16
    assert cache // 16 < c["memory_analysis"]["argument_size_in_bytes"] < cache
    assert set(c["collectives"]) == {"all-reduce", "all-gather"}
