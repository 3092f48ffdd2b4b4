"""Port parity of the sharded planner (`kernels/api.py`'s ShardSpec,
ShardedPlan and ShardedGroupedPlan, the cost model's `decide_schedule` and
`decide_sharding`) against the reference.

Pure arithmetic, in this process, against the reference's own functions:
ShardSpec validation and hashing, the schedule each spec resolves to with
its per-shard M/K/N, bytes moved and collective phases, and the cost
model's choices with every candidate's prediction, under the shipped
coefficients and under two calibrated sets (a slow link, a large launch
overhead).  The one-rank checks of the reference's
`tests/test_sharded_plan.py` run on the port: an unsharded ShardSpec equals
the plain plan bit for bit on each backend, the plan cache, describe(),
`layers.gemm`'s passthrough, `make_local_mesh` and the sharding rules.

Ranks: one reference subprocess with 8 virtual CPU devices (the pattern of
`tests/test_sharded_plan.py`) saves the reference's outputs of every
schedule, the `expert` schedule and Cannon's 2 x 2 matmul; one spawned
gloo group of 4 port ranks (a `file://` rendezvous in a temporary
directory, so parallel test workers never share a port) runs the same
cases on the `torch`, `cuda_mesh` (its plain version, on the CPU) and
`ref` backends.  Integer-valued operands: every rank's output bitwise equal
to the reference's; random f32: within 1e-5·max|ref|.  A planted
`collective.step` fault mid-ring raises under the default `fallback=False`
and degrades to replicated with the same bits under `fallback=True`.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels.api import Epilogue, GemmSpec, GroupSpec, ShardedPlan, ShardSpec  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B = 8
M, K, N = 24, 16, 12
WORLD = 4
SPAWN_TIMEOUT = 300

# Every case of the reference's `_check_numerics_all_schedules`, with the 2D
# meshes cut to 2 x 2 (four ranks): name -> (mesh shape, axis names, shard
# kwargs, operands).  "mm": (M, K) @ (K, N) with bias and an activation;
# "fold": a (2, 4, K) batch folded into M; "batched": (4, 6, K) @ (4, K, N).
# Across the packages the activation is relu, exact on integer data (gelu's
# tanh rounds differently in XLA and torch, by an ulp); each port rank also
# holds its gelu outputs against its own unsharded plan, bit for bit, as
# the reference's test does.
CASES = {
    "replicated[m=x,n=y]": ((2, 2), ("x", "y"), dict(m="x", n="y"), "mm"),
    "allgather_a": ((4,), ("x",), dict(m="x", schedule="allgather_a"), "mm"),
    "allgather_a_overlap": ((4,), ("x",), dict(m="x", schedule="allgather_a_overlap"), "mm"),
    "reduce_scatter_k": ((4,), ("x",), dict(k="x", schedule="reduce_scatter_k"), "mm"),
    "reduce_scatter_k_overlap": ((4,), ("x",), dict(k="x", schedule="reduce_scatter_k_overlap"),
                                 "mm"),
    "ring_k": ((4,), ("x",), dict(k="x", schedule="ring_k"), "mm"),
    "ring_k_overlap": ((4,), ("x",), dict(k="x", schedule="ring_k_overlap"), "mm"),
    "pipeline": ((4,), ("x",), dict(k="x", schedule="pipeline"), "mm"),
    "auto[k=x]": ((4,), ("x",), dict(k="x"), "mm"),
    "fold[m=x]": ((4,), ("x",), dict(m="x"), "fold"),
    "batched[batch=x,n=y]": ((2, 2), ("x", "y"), dict(batch="x", n="y"), "batched"),
}
BACKENDS = ("torch", "cuda_mesh", "ref")
FAULT_SCHEDULES = ("reduce_scatter_k_overlap", "ring_k_overlap", "allgather_a_overlap", "pipeline")
# the expert schedule: 8 groups of 4 rows over the 4 ranks, ragged sizes
GROUPS, RPG = 8, 4
SIZES = (4, 3, 0, 2, 4, 1, 4, 2)


def _mat(shape, seed, kind):
    """Integer-valued f32 (every partial sum exact, so every summation order
    agrees bit for bit) or normal f32."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _operands(case, kind):
    """(a, b, bias or None) of a case, as numpy."""
    op = CASES[case][3]
    if op == "mm":
        return _mat((M, K), 0, kind), _mat((K, N), 1, kind), _mat((N,), 2, kind)
    if op == "fold":
        return _mat((2, 4, K), 3, kind), _mat((K, N), 1, kind), None
    return _mat((4, 6, K), 5, kind), _mat((4, K, N), 4, kind), None


def _grouped_operands(kind):
    offsets = np.concatenate([[0], np.cumsum(SIZES)]).astype(np.int32)
    return _mat((GROUPS * RPG, K), 6, kind), offsets, _mat((GROUPS, K, N), 7, kind)


def _cannon_operands(kind):
    return _mat((8, 12), 8, kind), _mat((12, 16), 9, kind)


def _describe_numbers(p):
    sh = p.describe()["sharding"]
    return {k: sh[k] for k in ("schedule", "collective_phases", "bytes_moved",
                               "kernel_invocations", "per_shard_mkn", "per_shard_flops")}


# -- the reference's outputs: one subprocess with 8 virtual devices ---------------


def _reference_main(out_dir):
    """Run by the reference subprocess: every case through the reference's
    planner (backend `xla`), the expert schedule and Cannon, integer and
    random operands; outputs and describe() numbers saved to `out_dir`."""
    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.parallel.systolic import systolic_matmul

    outs, desc = {}, {}
    for case, (shape, axes, kw, op) in CASES.items():
        mesh = jmesh(shape, axes)
        for kind in ("int", "rand"):
            a, b, bias = (None if x is None else jnp.asarray(x) for x in _operands(case, kind))
            epi = (japi.Epilogue(bias=True, activation="relu") if bias is not None
                   else japi.Epilogue())
            spec = japi.GemmSpec.from_operands(a, b, epilogue=epi, blocks=(B, B, B),
                                               shard=japi.ShardSpec.from_mesh(mesh, **kw))
            p = japi.plan(spec, backend="xla", mesh=mesh)
            outs[f"{case}/{kind}"] = np.asarray(p(a, b, bias=bias))
        desc[case] = _describe_numbers(p)
    mesh = jmesh((WORLD,), ("x",))
    for kind in ("int", "rand"):
        t, off, w = (jnp.asarray(x) for x in _grouped_operands(kind))
        spec = japi.GemmSpec.for_groups(japi.GroupSpec(GROUPS, RPG), K, N,
                                        shard=japi.ShardSpec.from_mesh(mesh, g="x"))
        p = japi.plan(spec, backend="xla", mesh=mesh)
        outs[f"expert/{kind}"] = np.asarray(p(t, off, w))
        a, b = (jnp.asarray(x) for x in _cannon_operands(kind))
        outs[f"cannon/{kind}"] = np.asarray(
            systolic_matmul(a, b, mesh=jmesh((2, 2), ("data", "model"))))
    desc["expert"] = _describe_numbers(p)
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump(desc, f)


# -- the port's ranks: one gloo group of 4 --------------------------------------------


def _rank_main(rank, world, init_file, out_dir):
    """Run by each port rank: every case on every backend, the expert
    schedule, Cannon and the planted faults; this rank's outputs and
    findings saved to `out_dir`."""
    import torch.distributed as dist

    from repro_torch.parallel.systolic import systolic_matmul
    from repro_torch.resilience import faults, ledger

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    t = torch.as_tensor
    outs, found = {}, {"describe": {}, "faults": {}, "gelu": {}}
    meshes = {}
    for case, (shape, axes, kw, op) in CASES.items():
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = make_local_mesh(shape, axes)
        mesh = meshes[(shape, axes)]
        for backend in BACKENDS:
            for kind in ("int", "rand"):
                a, b, bias = (None if x is None else t(x) for x in _operands(case, kind))
                for act in ("relu", "gelu") if bias is not None else (None,):
                    epi = Epilogue(bias=bias is not None, activation=act)
                    spec = GemmSpec.from_operands(a, b, epilogue=epi, blocks=(B, B, B),
                                                  shard=ShardSpec.from_mesh(mesh, **kw))
                    p = api.plan(spec, backend=backend, mesh=mesh)
                    got = p(a, b, bias=bias)
                    if act != "gelu":
                        outs[f"{case}/{backend}/{kind}"] = got.numpy()
                    elif kind == "int":
                        plain = api.plan(dataclasses.replace(spec, shard=None), backend=backend)
                        found["gelu"][f"{case}/{backend}"] = bool(
                            torch.equal(got, plain(a, b, bias=bias)))
            found["describe"][f"{case}/{backend}"] = _describe_numbers(p)
    mesh = meshes[((WORLD,), ("x",))]
    for backend in BACKENDS:
        for kind in ("int", "rand"):
            tok, off, w = (t(x) for x in _grouped_operands(kind))
            spec = GemmSpec.for_groups(GroupSpec(GROUPS, RPG), K, N,
                                       shard=ShardSpec.from_mesh(mesh, g="x"))
            p = api.plan(spec, backend=backend, mesh=mesh)
            outs[f"expert/{backend}/{kind}"] = p(tok, off, w).numpy()
        found["describe"][f"expert/{backend}"] = _describe_numbers(p)
    grid = make_local_mesh((2, 2), ("data", "model"))
    for kind in ("int", "rand"):
        a, b = (t(x) for x in _cannon_operands(kind))
        outs[f"cannon/{kind}"] = systolic_matmul(a, b, mesh=grid).numpy()

    # A fault planted mid-ring (a step match: the first hops already ran).
    a, b = t(_mat((M, K), 0, "int")), t(_mat((K, N), 1, "int"))
    want = api.plan(GemmSpec.from_operands(a, b))(a, b)
    for sched in FAULT_SCHEDULES:
        kw = {"m": "x"} if sched.startswith("allgather") else {"k": "x"}
        spec = GemmSpec.from_operands(a, b, shard=ShardSpec.from_mesh(mesh, schedule=sched, **kw))
        step = (0, 1) if sched == "pipeline" else 1
        res = {}
        for fallback in (False, True):
            ledger.clear()
            p = api.plan(spec, mesh=mesh, fallback=fallback)
            try:
                with faults.inject({"collective.step": faults.FaultSpec(
                        times=1, match={"schedule": sched, "step": step})}):
                    got = p(a, b)
            except faults.FaultError:
                res[str(fallback)] = "raised"
                continue
            events = [dict(e.detail).get("schedule") for e in ledger.events("plan.execute")
                      if e.fallback == "replicated"]
            res[str(fallback)] = {"bitwise": bool(torch.equal(got, want)), "active": p._active,
                                  "events": events,
                                  "again": bool(torch.equal(p(a, b), want))}
        found["faults"][sched] = res
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **outs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _run(code, env):
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=SPAWN_TIMEOUT):
    """Wait for every process (killing all at the timeout), then assert each
    exited 0."""
    errs = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = proc.communicate()
            errs.append(f"timed out after {timeout} s\n{err[-3000:]}")
            continue
        if proc.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n---\n".join(errs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, started together: the reference subprocess and the
    port's 4 gloo ranks.  Returns their saved outputs and findings."""
    pytest.importorskip("jax")
    from repro.launch.mesh import forced_device_env

    out = tmp_path_factory.mktemp("sharded")
    env = forced_device_env(8, pythonpath=(str(ROOT / "src"), str(ROOT / "tests")))
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_sharded_plan as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_sharded_plan as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    found = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return types.SimpleNamespace(ref=dict(np.load(out / "reference.npz")),
                                 ref_desc=json.loads((out / "reference.json").read_text()),
                                 ranks=ranks, found=found)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES) + ["expert"])
def test_ranks_match_reference(runs, case, backend):
    """Integer data: every rank's output bitwise equal to the reference's;
    random f32 within 1e-5·max|ref|; the schedule, phases, bytes moved,
    per-shard M/K/N, FLOPs and kernel invocations the reference's."""
    want_int, want_rand = runs.ref[f"{case}/int"], runs.ref[f"{case}/rand"]
    lim = 1e-5 * float(np.abs(want_rand).max())
    for r, outs in enumerate(runs.ranks):
        got = outs[f"{case}/{backend}/int"]
        assert got.shape == want_int.shape and np.array_equal(got, want_int), (case, backend, r)
        err = float(np.abs(outs[f"{case}/{backend}/rand"] - want_rand).max())
        assert err <= lim, (case, backend, r, err, lim)
        assert runs.found[r]["describe"][f"{case}/{backend}"] == runs.ref_desc[case]
        assert runs.found[r]["gelu"].get(f"{case}/{backend}", True)


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_cannon_2x2_matches_reference(runs, kind):
    want = runs.ref[f"cannon/{kind}"]
    for outs in runs.ranks:
        got = outs[f"cannon/{kind}"]
        if kind == "int":
            assert np.array_equal(got, want)
        else:
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("sched", FAULT_SCHEDULES)
def test_collective_fault_raises_or_degrades(runs, sched):
    for found in runs.found:
        res = found["faults"][sched]
        assert res["False"] == "raised"
        deg = res["True"]
        assert deg["bitwise"] and deg["again"] and deg["active"] == "replicated"
        assert deg["events"] == [repr(sched)]


# -- pure arithmetic against the reference, in this process ------------------------


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import importlib

    from repro.costmodel import choose as jchoose
    from repro.costmodel import model as jmodel
    from repro.kernels import api as japi
    from repro.parallel import sharding as jsharding
    from repro.parallel.systolic import phase_counts

    return types.SimpleNamespace(api=japi, choose=jchoose, model=jmodel, sharding=jsharding,
                                 cal=importlib.import_module("repro.costmodel.calibrate"),
                                 phase_counts=phase_counts)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A scratch calibration file for both packages, fresh memos and plan
    caches."""
    import importlib

    tcal = importlib.import_module("repro_torch.costmodel.calibrate")
    from repro_torch.costmodel import choose as tchoose

    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "costmodel.json"))

    def clear():
        tcal.clear_coefficients_memo()
        tchoose.clear_decision_memo()
        api.clear_plan_cache()
        if "repro.costmodel.calibrate" in sys.modules:
            sys.modules["repro.costmodel.calibrate"].clear_coefficients_memo()
            sys.modules["repro.costmodel.choose"].clear_decision_memo()
            sys.modules["repro.kernels.api"].clear_plan_cache()

    clear()
    yield
    clear()


def _spec_pair(jx, build):
    """The same spec in both packages, from `build` over (GemmSpec,
    ShardSpec, GroupSpec, Epilogue)."""
    return (build(GemmSpec, ShardSpec, GroupSpec, Epilogue),
            build(jx.api.GemmSpec, jx.api.ShardSpec, jx.api.GroupSpec, jx.api.Epilogue))


X4 = (("x", 4),)
XY = (("x", 4), ("y", 2))
# label -> spec constructor: the reference tests' specs, every schedule pinned on
# them, auto where it resolves, and where it must raise.
RESOLVE = {
    "auto rs": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(X4, axis_k="x")),
    "auto ring": lambda G, S, Gr, E: G(m=6, k=32, n=8, shard=S(X4, axis_k="x")),
    "auto m": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(X4, axis_m="x")),
    "auto trivial": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S((("x", 1),))),
    "ag bf16": lambda G, S, Gr, E: G(m=16, k=32, n=8, dtype_a="bfloat16",
                                     shard=S(X4, axis_m="x", schedule="allgather_a")),
    "ag overlap": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                        shard=S(X4, axis_m="x", schedule="allgather_a_overlap")),
    "rs overlap": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                        shard=S(X4, axis_k="x", schedule="reduce_scatter_k_overlap")),
    "ring overlap": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                          shard=S(X4, axis_k="x", schedule="ring_k_overlap")),
    "pipeline": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(X4, axis_k="x", schedule="pipeline")),
    "pipeline odd": lambda G, S, Gr, E: G(m=12, k=32, n=8,
                                          shard=S(X4, axis_k="x", schedule="pipeline")),
    "2d": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(XY, axis_m="x", axis_n="y")),
    "fold": lambda G, S, Gr, E: G(m=4, k=32, n=8, batch=(2,), shard=S(X4, axis_m="x")),
    "batched": lambda G, S, Gr, E: G(m=6, k=16, n=12, batch=(4,), batched_b=True,
                                     shard=S(XY, axis_batch="x", axis_n="y")),
    "epilogue": lambda G, S, Gr, E: G(m=16, k=32, n=8, epilogue=E(bias=True, activation="gelu"),
                                      shard=S(X4, axis_k="x")),
    "mesh-paper ring": lambda G, S, Gr, E: G(m=4096, k=2048, n=8192, dtype_a="bfloat16",
                                             dtype_b="bfloat16", shard=S(X4, axis_k="x")),
    "expert": lambda G, S, Gr, E: G.for_groups(Gr(8, 4), 16, 12, shard=S(X4, axis_g="x")),
    "expert bf16": lambda G, S, Gr, E: G.for_groups(Gr(64, 8), 2048, 2048, dtype_a="bfloat16",
                                                    dtype_b="bfloat16", shard=S(X4, axis_g="x")),
    # each of these raises, in both packages, with the same message
    "odd n overlap": lambda G, S, Gr, E: G(m=16, k=32, n=9,
                                           shard=S(X4, axis_k="x", schedule="ring_k_overlap")),
    "replicated k": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                          shard=S(X4, axis_k="x", schedule="replicated")),
    "ring no k": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                       shard=S(X4, axis_m="x", schedule="ring_k")),
    "k and n": lambda G, S, Gr, E: G(m=16, k=32, n=8,
                                     shard=S(XY, axis_k="x", axis_n="y", schedule="ring_k")),
    "auto k and m": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(XY, axis_m="y", axis_k="x")),
    "batch no batch": lambda G, S, Gr, E: G(m=16, k=32, n=8, shard=S(X4, axis_batch="x")),
    "scrambled": lambda G, S, Gr, E: G(m=8, k=8, n=8, structure="scrambled", blocks=(8, 8, 8),
                                       shard=S(X4)),
    "indivisible m": lambda G, S, Gr, E: G(m=10, k=16, n=12, shard=S(X4, axis_m="x")),
}


def _resolution(api_mod, spec):
    try:
        sched, local, moved, phases, dec = api_mod._resolve_sharding(spec)
    except api_mod.PlanValidationError as e:
        return {"raises": str(e)}
    return {"schedule": sched, "local": (local.m, local.k, local.n, local.batch,
                                         local.out_dtype, local.epilogue.is_identity,
                                         None if local.group is None else
                                         (local.group.num_groups, local.group.rows_per_group)),
            "bytes": moved, "phases": phases, "decision": _candidates(dec)}


def _candidates(dec):
    """A decision's chosen name and candidates, the reference's backend
    names mapped to the port's."""
    if dec is None:
        return None
    return (dec["chosen"], [(c["name"], c["legal"], c.get("predicted_s"), c.get("pricing"))
                            for c in dec["candidates"]])


@pytest.mark.parametrize("label", list(RESOLVE))
def test_schedule_resolution_matches_reference(jx, label):
    ours, ref = _spec_pair(jx, RESOLVE[label])
    assert _resolution(api, ours) == _resolution(jx.api, ref)


CALIBRATIONS = {"default": {}, "slow link": dict(link_bytes_per_s=1e6),
                "launch overhead": dict(launch_overhead_s=1.0)}


def _calibrate(jx, tmp_path, monkeypatch, label):
    """Install `label`'s coefficients through a reference calibration file,
    which both packages read (the port maps the backend names)."""
    import importlib

    if not CALIBRATIONS[label]:
        return
    path = tmp_path / f"{label.replace(' ', '_')}.json"
    cache = jx.cal.CalibrationCache(path)
    cache.set_coefficients(dataclasses.replace(jx.model.default_coefficients("cpu"),
                                               **CALIBRATIONS[label]))
    cache.save()
    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(path))
    jx.cal.clear_coefficients_memo()
    importlib.import_module("repro_torch.costmodel.calibrate").clear_coefficients_memo()


@pytest.mark.parametrize("calibration", list(CALIBRATIONS))
def test_decide_schedule_matches_reference(jx, tmp_path, monkeypatch, calibration):
    from repro_torch.costmodel import choose

    _calibrate(jx, tmp_path, monkeypatch, calibration)
    for label in ("auto rs", "auto ring", "auto m", "epilogue", "mesh-paper ring", "2d"):
        ours, ref = _spec_pair(jx, RESOLVE[label])
        try:
            want = jx.choose.decide_schedule(ref)
        except jx.choose.NoLegalCandidate:
            with pytest.raises(choose.NoLegalCandidate):
                choose.decide_schedule(ours, platform="cpu")
            continue
        sched, dec = choose.decide_schedule(ours, platform="cpu")
        assert sched == want[0], (label, calibration)
        d, w = dec.as_dict(), want[1].as_dict()
        assert _candidates(d) == _candidates(w), (label, calibration)
        assert d["calibration"]["source"] == w["calibration"]["source"]


class _Layout:
    """A mesh as the reference's deciders read it: `.shape`, name -> size."""

    def __init__(self, *axes):
        self.shape = dict(axes)


SHARDING = {
    "mm on x4": (lambda G, S, Gr, E: G(m=16, k=32, n=8), (("x", 4),)),
    "mm on x4 y2": (lambda G, S, Gr, E: G(m=16, k=32, n=8), (("x", 4), ("y", 2))),
    "mm on x1": (lambda G, S, Gr, E: G(m=16, k=8, n=8), (("x", 1),)),
    "mesh-paper on x4": (lambda G, S, Gr, E: G(m=4096, k=2048, n=8192, dtype_a="bfloat16",
                                               dtype_b="bfloat16"), (("x", 4),)),
    "decode on x4": (lambda G, S, Gr, E: G(m=4, k=2048, n=8192, dtype_a="bfloat16",
                                           dtype_b="bfloat16"), (("x", 4),)),
    "batched on x4 y2": (lambda G, S, Gr, E: G(m=6, k=16, n=12, batch=(4,), batched_b=True),
                         (("x", 4), ("y", 2))),
    "grouped on x4": (lambda G, S, Gr, E: G.for_groups(Gr(8, 4), 16, 12), (("x", 4),)),
}


@pytest.mark.parametrize("calibration", list(CALIBRATIONS))
@pytest.mark.parametrize("label", list(SHARDING))
def test_decide_sharding_matches_reference(jx, tmp_path, monkeypatch, calibration, label):
    from repro_torch.costmodel import choose

    _calibrate(jx, tmp_path, monkeypatch, calibration)
    build, axes = SHARDING[label]
    ours, ref = _spec_pair(jx, build)
    shard, dec = choose.decide_sharding(ours, axes, platform="cpu")
    want_shard, want = jx.choose.decide_sharding(ref, _Layout(*axes))
    assert _candidates(dec.as_dict()) == _candidates(want.as_dict())
    assert (shard.mesh_axes, shard.axis_m, shard.axis_k, shard.axis_n, shard.axis_batch,
            shard.axis_g, shard.schedule) == (
        want_shard.mesh_axes, want_shard.axis_m, want_shard.axis_k, want_shard.axis_n,
        want_shard.axis_batch, want_shard.axis_g, want_shard.schedule)
    # memoized per (spec, mesh axes, platform, coefficients)
    assert choose.decide_sharding(ours, axes, platform="cpu")[1] is dec


def test_auto_shard_plan_records_the_decision():
    mesh = (("x", 1),)
    p = api.plan(GemmSpec(m=2 * B, k=B, n=B), mesh=mesh)
    assert isinstance(p, ShardedPlan) and p.spec.shard is not None
    assert p.describe()["decision"]["sharding"]["chosen"]
    pinned = api.plan(GemmSpec(m=2 * B, k=B, n=B, shard=ShardSpec.from_mesh(mesh, m="x")),
                      mesh=mesh)
    assert pinned.describe()["decision"]["schedule"]["chosen"] == pinned.schedule


@pytest.mark.parametrize("p", range(2, 9))
def test_phase_counts_match_reference(jx, p):
    from repro_torch.parallel.systolic import phase_counts

    pc = phase_counts(p)
    assert pc == jx.phase_counts(p)
    assert pc["kpass_ring_phases"] == p - 1 < pc["kpass_psum_phases"] == 2 * (p - 1)
    assert (pc["switched_phases"], pc["naive_phases"]) == (p + 1, 2 * p - 1)


# -- one rank: the reference's single-device checks ----------------------------------


def test_shardspec_validates_axes_and_schedule():
    mesh = make_local_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="not a mesh axis"):
        ShardSpec.from_mesh(mesh, m="rows")
    with pytest.raises(ValueError, match="schedule must be 'auto' or one of"):
        ShardSpec.from_mesh(mesh, k="model", schedule="cannon")
    with pytest.raises(ValueError, match="partitions more than one GEMM dim"):
        ShardSpec.from_mesh(mesh, m="model", n="model")
    with pytest.raises(ValueError, match="axis_k must be a single mesh axis"):
        ShardSpec.from_mesh(mesh, k=("data", "model"))
    with pytest.raises(ValueError, match="axis_g must be a single mesh axis"):
        ShardSpec.from_mesh(mesh, g=("data", "model"))
    with pytest.raises(ValueError, match="duplicate mesh axis"):
        ShardSpec((("x", 1), ("x", 2)))
    s = ShardSpec.from_mesh(mesh, m=("data", "model"), n=None)
    assert s.axis_m == ("data", "model") and s.axis_size(s.axis_m) == 1
    assert ShardSpec.from_mesh(mesh, m=("data",)).axis_m == "data"
    assert ShardSpec.from_mesh(mesh, k=["model"]).axis_k == "model"
    assert ShardSpec.unsharded(mesh).is_trivial
    assert not ShardSpec((("x", 4),), axis_k="x").is_trivial


def test_shardspec_is_hashable_spec_field():
    mesh = make_local_mesh((1,), ("model",))
    s1 = GemmSpec(m=B, k=B, n=B, shard=ShardSpec.from_mesh(mesh, m="model"))
    s2 = GemmSpec(m=B, k=B, n=B, shard=ShardSpec.from_mesh(mesh, m="model"))
    assert s1 == s2 and hash(s1) == hash(s2)
    assert s1 != GemmSpec(m=B, k=B, n=B)
    assert len({s1, s2, GemmSpec(m=B, k=B, n=B)}) == 2
    with pytest.raises(TypeError, match="shard must be a ShardSpec"):
        GemmSpec(m=B, k=B, n=B, shard="model")


def test_shardspec_from_rules_maps_logical_axes(jx):
    from repro_torch.parallel.sharding import DEFAULT_RULES

    mesh = make_local_mesh((1, 1), ("data", "model"))
    s = ShardSpec.from_rules(mesh, DEFAULT_RULES, m="batch", n="mlp")
    want = jx.api.ShardSpec.from_rules(_Layout(("data", 1), ("model", 1)),
                                       jx.sharding.DEFAULT_RULES, m="batch", n="mlp")
    # 'batch' -> ('pod','data') with 'pod' absent on this mesh; 'mlp' -> model
    assert (s.axis_m, s.axis_n, s.axis_k) == (want.axis_m, want.axis_n, want.axis_k) == (
        "data", "model", None)
    assert ShardSpec.from_rules(mesh, DEFAULT_RULES, k="seq").axis_k is None


def test_logical_to_physical_matches_reference(jx):
    from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, logical_to_physical

    layout = (("data", 1), ("model", 1))
    for axes, rules in ((("batch", "seq", "embed"), {}), (("embed", "mlp"), {}),
                        (("batch", "seq", "embed"), {"seq": "data"}), (("batch",), {})):
        ours = logical_to_physical(axes, layout, ShardingRules.make(rules) if rules
                                   else DEFAULT_RULES)
        want = jx.sharding.logical_to_physical(axes, _Layout(*layout),
                                               jx.sharding.ShardingRules.make(rules))
        assert tuple(ours) == tuple(want)
    with pytest.raises(KeyError, match="unknown logical axis"):
        DEFAULT_RULES.get("nope")
    assert DEFAULT_RULES.replace(seq="data").get("seq") == "data"


def test_plan_requires_matching_mesh_and_shardspec():
    mesh = make_local_mesh((1, 1), ("data", "model"))
    spec = GemmSpec(m=B, k=B, n=B, shard=ShardSpec.unsharded(mesh))
    with pytest.raises(ValueError, match="pass the device mesh"):
        api.plan(spec)
    other = make_local_mesh((1,), ("model",))
    with pytest.raises(ValueError, match="built for mesh axes"):
        api.plan(spec, mesh=other)


def test_sharding_capability_gates_backends():
    mesh = make_local_mesh((1,), ("model",))
    spec = GemmSpec(m=B, k=B, n=B, shard=ShardSpec.unsharded(mesh))
    api.register_backend("no_shard_double", lambda plan, a, b, bias, residual: a @ b,
                         {"structures": {"general"}, "sharding": False})
    try:
        with pytest.raises(api.CapabilityError, match="sharding"):
            api.plan(spec, backend="no_shard_double", mesh=mesh)
    finally:
        api.unregister_backend("no_shard_double")
    assert all(api.get_capabilities(b).sharding for b in BACKENDS)
    with pytest.raises(ValueError, match="unknown backend"):
        api.get_capabilities("xla")


@pytest.mark.parametrize("backend", BACKENDS)
def test_unsharded_shardspec_matches_plain_plan_bitwise(backend):
    mesh = make_local_mesh((1, 1), ("data", "model"))
    a, b = torch.as_tensor(_mat((2 * B, B), 0, "int")), torch.as_tensor(_mat((B, 3 * B), 1, "int"))
    bias = torch.as_tensor(_mat((3 * B,), 2, "int"))
    epi = Epilogue(bias=True, activation="gelu")
    want = api.plan(GemmSpec.from_operands(a, b, epilogue=epi, blocks=(B, B, B)),
                    backend=backend)(a, b, bias=bias)
    spec = GemmSpec.from_operands(a, b, epilogue=epi, blocks=(B, B, B),
                                  shard=ShardSpec.unsharded(mesh))
    p = api.plan(spec, backend=backend, mesh=mesh)
    assert isinstance(p, ShardedPlan) and p.schedule == "replicated"
    assert torch.equal(p(a, b, bias=bias), want)
    # cached: the identical object, and the per-shard plan is itself the
    # cached ordinary Plan (one planner, not two)
    assert api.plan(spec, backend=backend, mesh=mesh) is p
    assert p.local is api.plan(p.local.spec, backend=backend)
    h = p.dispatch(a, b, bias=bias)
    assert torch.equal(h.block(), want)


def test_sharded_plan_describe_provenance_and_roofline():
    from repro_torch.launch.roofline import analyze_plan

    mesh = make_local_mesh((1,), ("model",))
    spec = GemmSpec(m=2 * B, k=B, n=B, shard=ShardSpec.unsharded(mesh))
    d = api.plan(spec, mesh=mesh).describe()
    json.dumps(d)
    sh = d["sharding"]
    assert sh["mesh"] == [["model", 1]] and sh["schedule"] == "replicated"
    assert sh["per_shard_mkn"] == [2 * B, B, B]
    assert sh["per_shard_flops"] == 2 * 2 * B * B * B and sh["bytes_moved"] == 0
    assert d["fused_epilogue"] is False
    rl = analyze_plan(d)
    assert rl["t_collective_s"] == 0.0 and rl["dominant"] in ("compute", "memory")


def test_scrambled_structure_rejected_with_shard():
    mesh = make_local_mesh((1,), ("model",))
    spec = GemmSpec(m=B, k=B, n=B, structure="scrambled", blocks=(B, B, B),
                    shard=ShardSpec.unsharded(mesh))
    with pytest.raises(ValueError, match="scrambled.*does not compose"):
        api.plan(spec, mesh=mesh)


def test_layers_gemm_routes_shard():
    from repro_torch.configs import get_config
    from repro_torch.models.layers import dense, gemm

    cfg = dataclasses.replace(get_config("mesh-paper").reduced(), use_mesh_kernel=False)
    mesh = make_local_mesh((1, 1), ("data", "model"))
    x, w = torch.as_tensor(_mat((2 * B, B), 3, "int")), torch.as_tensor(_mat((B, B), 4, "int"))
    want = gemm(x, w, cfg)
    got = gemm(x, w, cfg, mesh=mesh, shard=ShardSpec.unsharded(mesh))
    assert torch.equal(got, want)
    assert torch.equal(dense(x, w, cfg, mesh=mesh, shard=ShardSpec.unsharded(mesh)), want)
    [desc] = [p for p in api.plan_cache_info()["plans"] if p.get("sharding")]
    assert desc["sharding"]["schedule"] == "replicated"


def test_plan_cache_keys_on_the_mesh():
    spec = GemmSpec(m=8, k=16, n=12, shard=ShardSpec.from_mesh((("x", 1),), k="x"))
    p1 = api.plan(spec, mesh=(("x", 1),))
    assert api.plan(spec, mesh={"x": 1}) is p1
    assert api.plan_cache_info()["size"] == 2  # the sharded plan and its local plan


def test_make_local_mesh_validates_the_world_size():
    with pytest.raises(ValueError, match="exceeds the world size 1"):
        make_local_mesh((64, 64), ("data", "model"))
    with pytest.raises(ValueError, match="equal rank"):
        make_local_mesh((1, 1), ("data",))
    assert make_local_mesh((1, 1), ("data", "model")) == (("data", 1), ("model", 1))


def test_layout_with_ranks_needs_a_device_mesh():
    from repro_torch.parallel.sharding import mesh_layout

    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        mesh_layout((("x", 4),))
    spec = GemmSpec(m=8, k=16, n=12, shard=ShardSpec.from_mesh((("x", 4),), k="x"))
    p = api.plan(spec, mesh=(("x", 4),))  # resolution and describe need no ranks
    assert p.schedule == "reduce_scatter_k" and p.describe()["sharding"]["bytes_moved"] == 288
    a, b = torch.ones(8, 16), torch.ones(16, 12)
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        p(a, b)


def test_drop_indivisible_warns_once_per_spec(jx):
    from repro_torch.parallel import sharding as shmod
    from repro_torch.parallel.sharding import PartitionSpec as P

    layout = _Layout(("data", 4), ("model", 16))
    shmod._WARNED_DROPS.clear()
    spec = P("model", None)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = shmod._drop_indivisible(spec, (49155, 128), layout)
        shmod._drop_indivisible(spec, (49155, 128), layout)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jx.sharding._drop_indivisible(jx.sharding.P("model", None), (49155, 128), layout)
    assert out == P(None, None) and tuple(out) == tuple(want)
    assert len([w for w in rec if "fell back to replicated" in str(w.message)]) == 1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shmod._drop_indivisible(spec, (40, 128), layout)
        assert shmod._drop_indivisible(spec, (49152, 128), layout) == spec
    assert len([w for w in rec if "fell back to replicated" in str(w.message)]) == 1


def test_parallel_package_exports_public_names(jx):
    import repro_torch.parallel as par
    from repro_torch.parallel import collectives, systolic

    import repro.parallel.collectives as jcoll
    import repro.parallel.systolic as jsys

    for mod, ref in ((collectives, jcoll), (systolic, jsys)):
        assert set(mod.__all__) == set(ref.__all__)
        for name in mod.__all__:
            assert hasattr(par, name) and name in par.__all__, name


def test_timed_tiebreak_reorders_the_top_two_by_measurement(monkeypatch):
    """Under $REPRO_COSTMODEL_TIMED=1 the two best-predicted candidates run
    as real plans and the measurement wins; off, the model's order stands."""
    from repro_torch.costmodel import choose
    from repro_torch.kernels import autotune

    mesh = (("x", 1), ("y", 1))
    spec = GemmSpec(m=2 * B, k=B, n=B)
    _, model_order = choose.decide_sharding(spec, mesh, platform="cpu")
    first, second = (c["name"] for c in model_order.candidates[:2])
    choose.clear_decision_memo()
    timed = iter([5.0, 1.0])  # the model's first measures slower
    monkeypatch.setattr(autotune, "measure_best_ms", lambda *a, **k: next(timed))
    monkeypatch.setenv("REPRO_COSTMODEL_TIMED", "1")
    shard, dec = choose.decide_sharding(spec, mesh, platform="cpu")
    got = dec.as_dict()["candidates"]
    assert [c["name"] for c in got[:2]] == [second, first]
    assert [c["measured_ms"] for c in got[:2]] == [1.0, 5.0] and dec.chosen == second
