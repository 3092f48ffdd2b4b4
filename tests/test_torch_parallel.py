"""The port's distribution building blocks on a spawned gloo group of 4
ranks (`repro_torch.parallel`, `launch/mesh.make_local_mesh`).

The reference's `tests/test_parallel.py` holds its ring collectives on
integer-valued f32 operands: every double-buffered helper (overlap=True,
`ring_pipeline_matmul`) bitwise equal to its serial twin and to the exact
product, and `systolic_matmul` (Cannon on a 2 x 2 mesh) against a @ b.
The same holds here, in one group of 4 processes (a `file://` rendezvous in
a temporary directory, so parallel test workers never share a port), plus:

  * random f32: serial and overlap bitwise equal, within 1e-5·max|ref| of
    the float64 product;
  * the `matmul=` hook runs each helper's local products, counted: one per
    rank for the gathers and the k-pass, two for their column-half twins,
    p for the reduce-scatter, the microbatch count for the pipeline;
  * a `collective.step` fault raised mid-ring on every rank leaves no hop
    pending: the next collective on the same ranks is right;
  * `psum_if_multi` sums over the ring and is the identity off the mesh;
  * `make_local_mesh` names the world size when the shape exceeds it.

The planner's schedules against the reference's outputs are in
tests/test_torch_sharded_plan.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 300
HELPERS = ("allgather", "reducescatter", "kpass", "pipeline")


def _mat(shape, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _rank_main(rank, world, init_file, out_dir):
    """Run by each rank: every helper serial and overlapped on integer and
    random operands, the hook's call counts, a fault mid-ring, psum and
    Cannon; this rank's findings saved to `out_dir`."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import (
        matmul_ring_reducescatter,
        psum_if_multi,
        ring_allgather_matmul,
        ring_pipeline_matmul,
        ring_systolic_kpass,
        systolic_matmul,
        systolic_matmul_shardmap,
    )
    from repro_torch.resilience import faults

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    mesh = make_local_mesh((world,), ("model",))
    found = {"helpers": {}}
    p = world

    def run(name, x, w, overlap, calls):
        def mm(a, b):
            calls.append(tuple(a.shape) + tuple(b.shape))
            return torch.matmul(a.float(), b.float())

        rows, cols = x.shape[0] // p, x.shape[1] // p
        if name == "allgather":
            return ring_allgather_matmul(x[rank * rows:(rank + 1) * rows], w, "model",
                                         mesh=mesh, matmul=mm, overlap=overlap)
        x_col, w_row = x[:, rank * cols:(rank + 1) * cols], w[rank * cols:(rank + 1) * cols]
        if name == "reducescatter":
            return matmul_ring_reducescatter(x_col, w_row, "model", mesh=mesh, matmul=mm,
                                             overlap=overlap)
        if name == "kpass":
            return ring_systolic_kpass(x_col, w_row, axis="model", mesh=mesh, matmul=mm,
                                       overlap=overlap)
        return ring_pipeline_matmul(x_col, w_row, "model", mesh=mesh, microbatches=8,
                                    matmul=mm)

    for kind in ("int", "rand"):
        x, w = torch.as_tensor(_mat((16, 8), 1, kind)), torch.as_tensor(_mat((8, 12), 2, kind))
        exact = x.double() @ w.double()
        for name in HELPERS:
            want = exact if name in ("allgather", "kpass") else exact[rank * 4:(rank + 1) * 4]
            serial_calls, overlap_calls = [], []
            serial = run(name, x, w, False, serial_calls)
            overlap = run(name, x, w, True, overlap_calls)
            found["helpers"][f"{name}/{kind}"] = {
                "serial_vs_overlap": bool(torch.equal(serial, overlap)),
                "err": float((overlap.double() - want).abs().max()),
                "scale": float(want.abs().max()),
                "calls": [len(serial_calls), len(overlap_calls)],
                "shape": list(overlap.shape),
            }

    # A fault mid-ring on every rank, then the same collective again.
    x, w = torch.as_tensor(_mat((16, 8), 1, "int")), torch.as_tensor(_mat((8, 12), 2, "int"))
    try:
        with faults.inject({"collective.step": faults.FaultSpec(
                times=1, match={"schedule": "allgather_a_overlap", "step": 2})}):
            run("allgather", x, w, True, [])
        found["fault"] = "not raised"
    except faults.FaultError:
        again = run("allgather", x, w, True, [])
        found["fault"] = bool(torch.equal(again.double(), x.double() @ w.double()))

    found["psum"] = psum_if_multi(torch.full((3,), float(rank + 1)), "model", mesh=mesh).tolist()
    found["psum_off_mesh"] = psum_if_multi(torch.ones(2), "data", mesh=mesh).tolist()

    grid = make_local_mesh((2, 2), ("data", "model"))
    for kind in ("int", "rand"):
        a, b = torch.as_tensor(_mat((8, 12), 3, kind)), torch.as_tensor(_mat((12, 16), 4, kind))
        c = systolic_matmul(a, b, mesh=grid)
        i, j = (int(v) for v in grid.get_coordinate())
        blk = systolic_matmul_shardmap(a[4 * i:4 * i + 4, 6 * j:6 * j + 6],
                                       b[6 * i:6 * i + 6, 8 * j:8 * j + 8],
                                       axis_x="data", axis_y="model", p=2, mesh=grid)
        want = a.double() @ b.double()
        found[f"cannon/{kind}"] = {
            "err": float((c.double() - want).abs().max()), "scale": float(want.abs().max()),
            "block": bool(torch.equal(blk, c[4 * i:4 * i + 4, 8 * j:8 * j + 8])),
        }
    try:
        make_local_mesh((8,), ("x",))
        found["too_big"] = "no error"
    except ValueError as e:
        found["too_big"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn: 4 gloo ranks, each killed at the timeout."""
    out = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_parallel as m; m._rank_main({r}, {WORLD},"
                               f" {str(out / 'rendezvous')!r}, {str(out)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = proc.communicate()
            errs.append(f"timed out after {SPAWN_TIMEOUT} s: {err[-3000:]}")
            continue
        if proc.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n---\n".join(errs)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]


# local products a rank runs: (serial, overlap); the pipeline has no serial
# twin (both runs take its one dataflow)
CALLS = {"allgather": [1, 2], "reducescatter": [WORLD, WORLD], "kpass": [1, 2],
         "pipeline": [8, 8]}


@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("name", HELPERS)
def test_ring_helper_overlap_is_bitwise_and_exact(ranks, name, kind):
    for found in ranks:
        got = found["helpers"][f"{name}/{kind}"]
        assert got["serial_vs_overlap"], (name, kind)
        assert got["calls"] == CALLS[name]
        assert got["shape"] == ([16, 12] if name in ("allgather", "kpass") else [4, 12])
        if kind == "int":
            assert got["err"] == 0.0
        else:
            assert got["err"] <= 1e-5 * got["scale"]


def test_fault_mid_ring_leaves_no_hop_pending(ranks):
    assert all(found["fault"] is True for found in ranks)


def test_psum_if_multi(ranks):
    for found in ranks:
        assert found["psum"] == [10.0] * 3
        assert found["psum_off_mesh"] == [1.0, 1.0]


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_cannon_on_a_2x2_mesh(ranks, kind):
    for found in ranks:
        got = found[f"cannon/{kind}"]
        assert got["block"]
        assert got["err"] == 0.0 if kind == "int" else got["err"] <= 1e-5 * got["scale"]


def test_make_local_mesh_names_the_world_size(ranks):
    for found in ranks:
        assert "exceeds the world size 4" in found["too_big"]
