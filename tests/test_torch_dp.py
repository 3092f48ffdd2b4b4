"""Data-parallel training of the port against the reference
(`repro_torch.parallel.{sharding,compression,pipeline}`, `optim.zero`,
`train.train_step.make_train_step(mesh=)` and
`make_dp_train_step_compressed`, `launch/train.py --mesh local-dp`).

In this process, against the reference's own functions: the rule tests of
`tests/test_parallel.py` and `tests/test_optim_data.py` re-run in both
packages, and `tree_shardings` of every config's `logical_axes()` on the
layouts (1, 1), (4, 1), (2, 2) and (4, 16) (plain layouts, no ranks).

Ranks: one reference subprocess with 4 virtual CPU devices and one gloo
group of 4 port ranks (a `file://` rendezvous in a temporary directory),
started together.  Both run the same cases on the same numpy inputs:
`compressed_psum_mean` / `compressed_pmean_tree` against `shard_map`, the
reference's `test_pipeline_parallel_4dev` case, the compressed DP step on
reduced Qwen2-7B (15 overfit steps, and 3 steps from the same parameters),
and `build_trainer(mesh=)` on reduced mesh-paper against the reference's
pjit trainer.  The port's ranks also hold their DP steps against the
port's single-process step, run in this process: global MoE routing with
and without capacity drops, a batch that does not split evenly,
gradient accumulation, the CLI on 4 ranks, and a failure on one rank that
makes every rank restore the same checkpoint.
"""

import io
import json
import os
import socket
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 300
ARCHS = sorted(["mesh-paper", "olmoe-1b-7b", "qwen2-7b", "qwen2-moe-a2.7b", "granite-3-8b",
                "phi3-medium-14b", "mistral-large-123b", "rwkv6-1.6b", "zamba2-1.2b",
                "pixtral-12b", "whisper-medium"])
LAYOUTS = [(1, 1), (4, 1), (2, 2), (4, 16)]
# The trainer comparison: reduced mesh-paper, 8 x 16 tokens, 3 steps.
TRAIN = dict(batch=8, seq=16, lr=3e-4, total_steps=10)
TRAIN_STEPS = 3
# Compressed DP: the reference's test_dp_train_step_compressed_4dev.
COMP_STEPS, COMP_LR = 15, 3e-3
# MoE under global routing: (rows, seq), capacity routing drops pairs at
# seq 512 (groups of 512 tokens) once the router is skewed.
MOE_CASES = {"no_drops": (4, 16), "drops": (4, 512)}


def _np_tree(specs, seed, skew_router=False):
    """Parameters drawn with numpy from `seed` in sorted path order, f32
    (the reduced configs' dtype), for either package's PSpec tree.  With
    `skew_router`, expert j's router column is scaled by 8 (1 + j): the
    later experts draw most tokens, so capacity routing drops pairs."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], f"{path}/{k}") for k in sorted(node)}
        if node.init == "zeros":
            return np.zeros(node.shape, np.float32)
        if node.init == "ones":
            return np.ones(node.shape, np.float32)
        arr = rng.normal(size=node.shape) * node.scale
        if skew_router and path.endswith("router"):
            arr = arr * 8 * (1 + np.arange(node.shape[-1]))
        return arr.astype(np.float32)

    return walk(specs, "")


def _np_train_state(params, err_ranks=0):
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} if isinstance(t, dict) else (  # noqa: E731
        np.zeros(t.shape, np.float32))
    state = {"params": params, "opt": {"m": zeros(params), "v": zeros(params),
                                       "count": np.zeros((), np.int32)},
             "step": np.zeros((), np.int32)}
    if err_ranks:
        state["err"] = tree_map(lambda p: np.zeros((err_ranks,) + p.shape, np.float32), params)
    return state


def _comp_batch(vocab):
    toks = np.random.default_rng(1).integers(0, vocab, size=(8, 16)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _moe_batch(rows, seq, vocab):
    toks = np.random.default_rng(5).integers(0, vocab, size=(rows, seq)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _moe_cfg():
    """Reduced OLMoE under `dots`: the backward recomputes the routing."""
    import dataclasses

    return dataclasses.replace(get_config("olmoe-1b-7b").reduced(), remat_policy="dots")


def _compression_inputs():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(WORLD, 64)).astype(np.float32)
    e = (rng.normal(size=(WORLD, 64)) * 0.01).astype(np.float32)
    tree = {"a": rng.normal(size=(WORLD, 16, 8)).astype(np.float32),
            "b": (rng.normal(size=(WORLD, 32)) * 3).astype(np.float32)}
    return g, e, tree


def _pipeline_inputs():
    rng = np.random.default_rng(3)
    ws = (rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.5).astype(np.float32)
    x = rng.normal(size=(6, 2, 8)).astype(np.float32)
    return ws, x


# -- the reference: one subprocess with 4 virtual devices ---------------------------


def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.launch.train import build_trainer as jbuild
    from repro.models import get_model as jmodel
    from repro.optim import constant
    from repro.parallel.compression import compressed_pmean_tree as jtree
    from repro.parallel.compression import compressed_psum_mean as jmean
    from repro.parallel.pipeline import pipeline_apply as jpipe
    from repro.parallel.sharding import shard_map
    from repro.train.train_step import make_dp_train_step_compressed as jcomp

    outs = {}
    mesh = jmesh((WORLD,), ("data",))
    g, e, tree = _compression_inputs()
    f = shard_map(lambda gb, eb: jmean(gb[0], eb[0], ("data",)), mesh=mesh,
                  in_specs=(JP("data", None), JP("data", None)), out_specs=(JP(), JP("data")),
                  check_vma=False)
    for name, err in (("zero", np.zeros_like(e)), ("carried", e)):
        mean, new_e = f(jnp.asarray(g), jnp.asarray(err))
        # out_specs P("data") concatenates the ranks' residuals on dim 0
        outs[f"mean/{name}"] = np.asarray(mean)
        outs[f"err/{name}"] = np.asarray(new_e).reshape(g.shape)
    ftree = shard_map(lambda t, z: jtree(jax.tree.map(lambda x: x[0], t),
                                         jax.tree.map(lambda x: x[0], z), ("data",)),
                      mesh=mesh, in_specs=(JP("data"), JP("data")),
                      out_specs=(JP(), JP("data")), check_vma=False)
    mt, et = ftree({k: jnp.asarray(v) for k, v in tree.items()},
                   {k: jnp.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        outs[f"tree_mean/{k}"] = np.asarray(mt[k])
        outs[f"tree_err/{k}"] = np.asarray(et[k]).reshape(tree[k].shape)

    ws, x = _pipeline_inputs()
    outs["pipeline"] = np.asarray(jpipe(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                                        jnp.asarray(x), mesh=jmesh((WORLD,), ("stage",))))

    cfg = jconfig("qwen2-7b").reduced()
    model = jmodel(cfg)
    state = jax.tree.map(jnp.asarray, _np_train_state(_np_tree(model.specs(), 0), WORLD))
    step = jax.jit(jcomp(model, constant(COMP_LR), mesh, dp_axes=("data",)))
    batch = {k: jnp.asarray(v) for k, v in _comp_batch(cfg.vocab_size).items()}
    losses = []
    for i in range(COMP_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            for key, leaf in tree_paths(jax.tree.map(np.asarray, state["err"])):
                outs[f"comp_err1/{key}"] = leaf
    outs["comp_losses"] = np.asarray(losses)

    mcfg = jconfig("mesh-paper").reduced()
    step, state, data = jbuild(mcfg, mesh=jmesh((WORLD, 1), ("data", "model")), **TRAIN)
    # The shared numpy parameters, placed on the trainer's shardings.
    fresh = jax.tree.map(jnp.asarray, _np_train_state(_np_tree(jmodel(mcfg).specs(), 7)))
    state = jax.device_put(fresh, jax.tree.map(lambda a: a.sharding, state))
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    outs["trainer_losses"] = np.asarray(losses)
    for key, leaf in tree_paths(jax.tree.map(np.asarray, state["params"])):
        outs[f"trainer_params/{key}"] = leaf
    for key, leaf in tree_paths(jax.tree.map(np.asarray, state["opt"]["v"])):
        outs[f"trainer_v/{key}"] = leaf
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: one gloo group of 4 ranks ---------------------------------------------


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import constant
    from repro_torch.parallel import (
        compressed_pmean_tree,
        compressed_psum_mean,
        gather_global,
        named_sharding,
        pipeline_apply,
        shard_of,
    )
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.train.train_step import make_dp_train_step_compressed, make_train_step

    torch.set_num_threads(1)
    assert init_distributed("cpu", f"file://{init_file}", world_size=world, rank=rank) == (
        world, rank)
    outs, found = {}, {}
    t = torch.as_tensor
    data_mesh = make_local_mesh((world,), ("data",))
    dp_mesh = make_local_mesh((world, 1), ("data", "model"))

    g, e, tree = _compression_inputs()
    for name, err in (("zero", np.zeros_like(e)), ("carried", e)):
        mean, new_e = compressed_psum_mean(t(g[rank]), t(err[rank]), ("data",), mesh=data_mesh)
        outs[f"mean/{name}"], outs[f"err/{name}"] = mean.numpy(), new_e.numpy()
    mt, et = compressed_pmean_tree({k: t(v[rank]) for k, v in tree.items()},
                                   {k: torch.zeros(v.shape[1:]) for k, v in tree.items()},
                                   ("data",), mesh=data_mesh)
    for k in tree:
        outs[f"tree_mean/{k}"], outs[f"tree_err/{k}"] = mt[k].numpy(), et[k].numpy()

    ws, x = _pipeline_inputs()
    outs["pipeline"] = pipeline_apply(lambda w, h: torch.tanh(h @ w), t(ws[rank:rank + 1]),
                                      t(x), mesh=make_local_mesh((world,), ("stage",))).numpy()

    # shard_of / gather_global on a 2 x 2 mesh.
    grid = make_local_mesh((2, 2), ("data", "model"))
    full = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3)
    sh = named_sharding(("batch", "mlp", None), grid)
    blk = shard_of(full, sh)
    found["shard"] = {"spec": list(sh.spec), "block": list(blk.shape),
                      "roundtrip": bool(torch.equal(gather_global(blk, sh), full)),
                      "replicated": bool(torch.equal(
                          shard_of(full, NamedSharding(grid, PartitionSpec())), full))}

    # The compressed DP step on reduced Qwen2-7B.
    cfg = get_config("qwen2-7b").reduced()
    model = get_model(cfg)
    params = _np_tree(model.specs(), 0)
    state = interop.params_from_numpy(_np_train_state(params), "cpu")
    state["err"] = tree_map(lambda p: torch.zeros((1,) + tuple(p.shape)), state["params"])
    step = make_dp_train_step_compressed(model, constant(COMP_LR), data_mesh)
    batch = _comp_batch(cfg.vocab_size)
    losses = []
    for i in range(COMP_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            for key, leaf in tree_paths(interop.train_state_to_numpy(state["err"])):
                outs[f"comp_err1/{key}"] = leaf
    outs["comp_losses"] = np.asarray(losses)

    # build_trainer(mesh=) on reduced mesh-paper from the shared parameters.
    mcfg = get_config("mesh-paper").reduced()
    step, _, data = ttrain.build_trainer(mcfg, mesh=dp_mesh, device="cpu", **TRAIN)
    state = interop.train_state_from_numpy(
        _np_train_state(_np_tree(get_model(mcfg).specs(), 7)), "cpu")
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    outs["trainer_losses"] = np.asarray(losses)
    for key, leaf in tree_paths(interop.train_state_to_numpy(state["params"])):
        outs[f"trainer_params/{key}"] = leaf

    # The global batch's gradients: MoE routing, an uneven split, accumulation.
    def dp_grads(cfg, seed, batch, grad_accum=1, skew_router=False):
        model = get_model(cfg)
        params = interop.params_from_numpy(_np_tree(model.specs(), seed, skew_router), "cpu")
        step = make_train_step(model, constant(1e-3), grad_accum=grad_accum, mesh=dp_mesh)
        grads, metrics = step.grads(params, batch)
        return grads, {k: float(v) for k, v in metrics.items()}

    for case, (rows, seq) in MOE_CASES.items():
        grads, found[f"moe/{case}"] = dp_grads(_moe_cfg(), 3, _moe_batch(rows, seq, 256),
                                               skew_router=True)
        for key, leaf in tree_paths(grads):
            outs[f"moe/{case}/{key}"] = leaf.numpy()
    for name, rows, accum in (("uneven", 6, 1), ("accum", 8, 2)):
        grads, found[name] = dp_grads(mcfg, 4, _moe_batch(rows, 16, 256), grad_accum=accum)
        for key, leaf in tree_paths(grads):
            outs[f"{name}/{key}"] = leaf.numpy()

    # A failure on rank 1 at step 2: every rank restores step 2 and ends
    # where a run without the failure ends.
    def run(hook, ckpt_dir):
        step, state, data = ttrain.build_trainer(mcfg, mesh=dp_mesh, device="cpu", **TRAIN)
        ckpt = None
        if ckpt_dir is not None:
            from repro_torch.checkpoint import CheckpointManager

            ckpt = CheckpointManager(ckpt_dir)
        log = io.StringIO()
        state = train_loop(step, state, data, LoopConfig(total_steps=4, ckpt_every=1),
                           ckpt=ckpt, logger=MetricsLogger(stream=log), failure_hook=hook,
                           group=dist.group.WORLD)
        return state, log.getvalue()

    def hook(step):
        if rank == 1 and step == 2 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected crash")

    crashed = []
    clean, _ = run(None, None)
    restored, log = run(hook, os.path.join(out_dir, "crash_ckpt"))
    found["crash"] = {"restored": "restoring step 2" in log,
                      "bitwise": all(torch.equal(a, b) for a, b in
                                     zip(tree_leaves(clean), tree_leaves(restored)))}

    # The CLI on the 4 ranks: checkpoints from rank 0 alone, every rank resumes.
    ckpt_dir = os.path.join(out_dir, "cli_ckpt")
    argv = ["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--mesh", "local-dp",
            "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "2", "--log-every", "1"]
    cli = io.StringIO()
    with redirect_stdout(cli):
        ttrain.main(argv)
        ttrain.main(argv[:8] + ["4"] + argv[9:] + ["--resume", "auto"])
    found["cli"] = cli.getvalue()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **outs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _run(code, env):
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=SPAWN_TIMEOUT):
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

    out = tmp_path_factory.mktemp("dp")
    env = forced_device_env(WORLD, pythonpath=(str(ROOT / "src"), str(ROOT / "tests")))
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_dp as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
                    OMP_NUM_THREADS="1")
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_dp as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    return types.SimpleNamespace(
        ref=dict(np.load(out / "reference.npz")),
        ranks=[dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
        found=[json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)],
        ckpts=sorted(os.listdir(out / "cli_ckpt")))


# -- the rule tests of the reference, in both packages --------------------------------


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """The sharding, pipeline and ZeRO modules of one package, with a plain
    (1, 1) ("data", "model") mesh of it."""
    if request.param == "reference":
        pytest.importorskip("jax")
        from repro.launch.mesh import make_local_mesh
        from repro.optim import zero
        from repro.parallel import pipeline, sharding
    else:
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.optim import zero
        from repro_torch.parallel import pipeline, sharding
    return types.SimpleNamespace(sharding=sharding, pipeline=pipeline, zero=zero,
                                 mesh=make_local_mesh((1, 1), ("data", "model")))


def _spec(spec):
    return tuple(spec)


def test_logical_to_physical_basic(pkg):
    sh = pkg.sharding
    assert _spec(sh.logical_to_physical(("batch", "seq", "embed"), pkg.mesh)) == (
        "data", None, None)
    assert _spec(sh.logical_to_physical(("embed", "mlp"), pkg.mesh)) == (None, "model")


def test_duplicate_physical_axis_dropped(pkg):
    rules = pkg.sharding.ShardingRules.make({"seq": "data"})
    assert _spec(pkg.sharding.logical_to_physical(("batch", "seq", "embed"), pkg.mesh, rules)) == (
        "data", None, None)


def test_missing_mesh_axis_dropped(pkg):
    assert _spec(pkg.sharding.logical_to_physical(("batch",), pkg.mesh)) == ("data",)


def test_indivisible_dim_falls_back_to_replicated(pkg):
    class FakeMesh:
        shape = {"data": 4, "model": 16}

    spec = pkg.sharding.P("model", None)
    assert _spec(pkg.sharding._drop_indivisible(spec, (49155, 128), FakeMesh())) == (None, None)
    assert _spec(pkg.sharding._drop_indivisible(spec, (49152, 128), FakeMesh())) == (
        "model", None)


def test_tree_shardings_structure(pkg):
    tree = {"w": ("embed", "mlp"), "b": None}
    avals = {"w": types.SimpleNamespace(shape=(8, 16)), "b": types.SimpleNamespace(shape=())}
    sh = pkg.sharding.tree_shardings(tree, pkg.mesh, pkg.sharding.DEFAULT_RULES, avals)
    assert _spec(sh["w"].spec) == (None, "model") and _spec(sh["b"].spec) == ()


def test_named_rules_tables(pkg):
    sh = pkg.sharding
    assert sh.PARAM_RULES.get("embed") == ("pod", "data")
    assert sh.TRAIN_RULES.get("seq_sp") == "model"
    assert (sh.SP_DECODE_RULES.get("kv_seq"), sh.SP_DECODE_RULES.get("kv_batch"),
            sh.SP_DECODE_RULES.get("batch")) == (("pod", "data"), None, None)


def test_zero1_rules_shard_embed_over_dp(pkg):
    rules = pkg.zero.zero1_rules(pkg.sharding.DEFAULT_RULES)
    assert _spec(pkg.sharding.logical_to_physical(("embed", "mlp"), pkg.mesh, rules)) == (
        "data", "model")
    assert _spec(pkg.sharding.logical_to_physical(("embed", "mlp"), pkg.mesh)) == (None, "model")
    assert pkg.zero.zero1_state_axes({"w": ("embed",)}) == {
        "m": {"w": ("embed",)}, "v": {"w": ("embed",)}, "count": None}


def test_bubble_fraction(pkg):
    bf = pkg.pipeline.bubble_fraction
    assert bf(4, 12) == pytest.approx(3 / 15)
    assert bf(1, 8) == 0.0
    assert bf(4, 12, schedule="1f1b") == pytest.approx(3 / 15)


def test_pipeline_ticks_fill_steady_drain(pkg):
    ticks = pkg.pipeline.pipeline_ticks
    g = ticks(4, 12)
    assert (g["fill"], g["steady"], g["drain"]) == (3, 9, 3)
    assert g["total"] == 15 and g["bubble"] == 3 and g["peak_in_flight"] == 12
    f = ticks(4, 12, schedule="1f1b")
    assert (f["fill"], f["steady"], f["drain"]) == (3, 24, 3)
    assert f["total"] == 30 and f["bubble"] == 6 and f["peak_in_flight"] == 4
    assert ticks(4, 2, schedule="1f1b")["peak_in_flight"] == 2
    for d in (g, f):
        assert d["total"] == d["fill"] + d["steady"] + d["drain"]
        assert d["bubble_fraction"] == pytest.approx(d["bubble"] / d["total"])
    assert ticks(1, 8)["bubble"] == 0
    with pytest.raises(ValueError, match="schedule"):
        ticks(4, 12, schedule="interleaved")
    with pytest.raises(ValueError):
        ticks(0, 12)


def test_parallel_exports_cover_the_reference():
    """Every public name of `repro.parallel` and `repro.optim.zero` is in the
    port's, but `shard_map` and `constrain` (SPMD by hand has no shard_map;
    `constrain` comes with tensor-parallel model code)."""
    pytest.importorskip("jax")
    import repro.optim.zero as jzero
    import repro.parallel as jpar
    import repro_torch.optim as topt
    import repro_torch.parallel as tpar

    assert set(jpar.__all__) - {"shard_map", "constrain"} <= set(tpar.__all__)
    assert set(jzero.__all__) <= set(topt.__all__)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_of_every_config_match_reference(arch):
    """`tree_shardings(model.logical_axes(), layout, rules, params)` of every
    config at full width: the reference's PartitionSpecs on each layout and
    rules table, indivisible dims dropped alike (shapes only, no ranks)."""
    pytest.importorskip("jax")
    import warnings

    from repro.configs import get_config as jconfig
    from repro.models import get_model as jmodel
    from repro.optim.zero import zero1_rules as jzero1
    from repro.parallel import sharding as jsh
    from repro_torch.optim import zero1_rules
    from repro_torch.parallel import sharding as tsh

    tm, jm = get_model(get_config(arch)), jmodel(jconfig(arch))
    t_axes, j_axes = tm.logical_axes(), jm.logical_axes()
    assert dict(tree_paths(t_axes)) == dict(tree_paths(j_axes))
    avals = tree_map(lambda s: types.SimpleNamespace(shape=s.shape), tm.specs())

    class JMesh:  # the reference's rules read only mesh.shape
        def __init__(self, shape):
            self.shape = shape

    for layout in LAYOUTS:
        shape = dict(zip(("data", "model"), layout))
        for rules_t, rules_j in ((tsh.DEFAULT_RULES, jsh.DEFAULT_RULES),
                                 (tsh.PARAM_RULES, jsh.PARAM_RULES),
                                 (zero1_rules(), jzero1())):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                got = tsh.tree_shardings(t_axes, tuple(shape.items()), rules_t, avals)
                # the reference's named_sharding(axes, mesh, rules, shape)
                want = {k: tuple(jsh._drop_indivisible(
                    jsh.logical_to_physical(axes, JMesh(shape), rules_j), aval.shape,
                    JMesh(shape)))
                    for (k, axes), (_, aval) in zip(tree_paths(j_axes), tree_paths(avals))}
            assert {k: tuple(v.spec) for k, v in tree_paths(got)} == want, (arch, layout)


def test_compressed_state_holds_this_ranks_residual_slice():
    """`init_dp_train_state_compressed`: the train state plus zero f32
    residuals of shape (1, *param_shape); `interop.stack_ranks` of the
    ranks' slices has the reference's (dp, *param_shape) leaves."""
    from repro_torch.train.train_step import init_dp_train_state_compressed

    model = get_model(get_config("qwen2-7b").reduced())
    state = init_dp_train_state_compressed(model, torch.Generator().manual_seed(0), "cpu")
    assert set(state) == {"params", "opt", "step", "err"}
    for (key, p), (_, e) in zip(tree_paths(state["params"]), tree_paths(state["err"])):
        assert e.shape == (1,) + p.shape and e.dtype == torch.float32 and not e.any(), key
    stacked = interop.stack_ranks([interop.train_state_to_numpy(state["err"])] * WORLD)
    for (key, p), (_, e) in zip(tree_paths(state["params"]), tree_paths(stacked)):
        assert e.shape == (WORLD,) + p.shape, key


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_one_rank_mesh_step_is_the_plain_step(grad_accum):
    """`make_train_step` on a one-rank ("data", "model") layout is the step
    without a mesh: two steps of reduced mesh-paper give bitwise equal
    losses, grad norms and parameters."""
    from repro_torch.optim import constant
    from repro_torch.train.train_step import init_train_state, make_train_step

    model = get_model(get_config("mesh-paper").reduced())
    batch = _moe_batch(4, 16, 256)
    runs = []
    for mesh in (None, (("data", 1), ("model", 1))):
        state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(model, constant(1e-3), grad_accum=grad_accum, mesh=mesh)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, tree_leaves(state["params"])))
    (m0, p0), (m1, p1) = runs
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# -- ranks against the reference -------------------------------------------------------


@pytest.mark.parametrize("err", ["zero", "carried"])
def test_compressed_psum_mean_matches_reference(runs, err):
    """Every rank's mean and its residual row against the reference's
    shard_map: bitwise (torch.round and jnp.round both round half to even)."""
    for r, outs in enumerate(runs.ranks):
        assert np.array_equal(outs[f"mean/{err}"], runs.ref[f"mean/{err}"]), r
        assert np.array_equal(outs[f"err/{err}"], runs.ref[f"err/{err}"][r]), r
    g, e, _ = _compression_inputs()
    e = e if err == "carried" else np.zeros_like(e)
    scale = np.abs(g + e).max() / 127.0
    assert np.abs(runs.ref[f"mean/{err}"] - (g + e).mean(0)).max() <= scale / 2 + 1e-6


def test_compressed_pmean_tree_matches_reference(runs):
    for r, outs in enumerate(runs.ranks):
        for k in ("a", "b"):
            assert np.array_equal(outs[f"tree_mean/{k}"], runs.ref[f"tree_mean/{k}"]), (r, k)
            assert np.array_equal(outs[f"tree_err/{k}"], runs.ref[f"tree_err/{k}"][r]), (r, k)


def test_pipeline_apply_matches_reference(runs):
    ws, x = _pipeline_inputs()
    seq = x
    for s in range(4):
        seq = np.tanh(seq @ ws[s])
    for outs in runs.ranks:
        np.testing.assert_allclose(outs["pipeline"], runs.ref["pipeline"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(outs["pipeline"], seq, rtol=1e-4, atol=1e-4)


def test_compressed_dp_step_overfits_and_matches_reference(runs):
    """The reference's test_dp_train_step_compressed_4dev (reduced Qwen2-7B,
    15 overfit steps, the loss falls by 0.5) on both packages from the same
    parameters: the first 3 losses within 1e-4, the ranks' residuals after
    step 1, stacked, within one quantization step of the reference's."""
    want = runs.ref["comp_losses"]
    assert want[-1] < want[0] - 0.5, want
    for outs in runs.ranks:
        got = outs["comp_losses"]
        assert got[-1] < got[0] - 0.5, got
        np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-4)
    keys = [k for k in runs.ref if k.startswith("comp_err1/")]
    assert keys
    for k in keys:
        stacked = interop.stack_ranks([outs[k] for outs in runs.ranks])
        want = runs.ref[k]
        assert stacked.shape == want.shape == (WORLD,) + want.shape[1:]
        # |residual| <= scale / 2, so a level flipped by the packages'
        # gradient roundings moves one element by one step, about
        # 2·max|residual|; every other element agrees within rounding.
        step = 2 * np.abs(want).max()
        d = np.abs(stacked - want)
        flipped = d > 1e-4 * step
        assert d.max() <= 1.05 * step and flipped.mean() <= 1e-3, (k, d.max(), flipped.sum())


def _single_process_trainer(steps=TRAIN_STEPS):
    """The port's single-process trainer from the shared parameters: its
    losses, final parameters and AdamW second moments, as numpy."""
    from repro_torch.launch import train as ttrain

    cfg = get_config("mesh-paper").reduced()
    step, _, data = ttrain.build_trainer(cfg, device="cpu", **TRAIN)
    state = interop.train_state_from_numpy(
        _np_train_state(_np_tree(get_model(cfg).specs(), 7)), "cpu")
    losses = []
    for _ in range(steps):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    numpy = lambda t: {k: v.detach().numpy() for k, v in tree_paths(t)}  # noqa: E731
    return np.asarray(losses), numpy(state["params"]), numpy(state["opt"]["v"])


def test_local_dp_trainer_matches_reference_and_single_process(runs):
    """`build_trainer(mesh=)` on 4 ranks, 3 steps of 8 x 16 tokens at the
    trainer's default lr from the same parameters: the losses within 1e-5
    relative of the reference's pjit trainer and of the port's
    single-process trainer, and every rank's parameters bitwise equal.
    The final parameters within 1e-5·max|ref| where AdamW's step is
    well-conditioned, sqrt(v) above 1e-3 of the leaf's largest: where it
    divides a gradient near its eps (1e-8; e.g. an embedding row whose
    gradient is 1e-9), the update follows rounding, and two single-process
    runs of the two packages already differ there by 2.9x that limit, so
    those elements are held within 3x the sum of the steps' lr."""
    from repro_torch.optim import warmup_cosine

    sched = warmup_cosine(TRAIN["lr"], min(100, TRAIN["total_steps"] // 10 + 1),
                          TRAIN["total_steps"])
    lr_sum = sum(float(sched(torch.tensor(i))) for i in range(TRAIN_STEPS))
    losses, params, v_single = _single_process_trainer()
    strip = lambda pre, d: {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}  # noqa: E731
    for want_l, want_p, want_v in (
            (runs.ref["trainer_losses"], strip("trainer_params/", runs.ref),
             strip("trainer_v/", runs.ref)), (losses, params, v_single)):
        assert want_p.keys() == params.keys() == want_v.keys()
        for outs in runs.ranks:
            np.testing.assert_allclose(outs["trainer_losses"], want_l, rtol=1e-5, atol=0)
            for k, want in want_p.items():
                d = np.abs(outs[f"trainer_params/{k}"] - want)
                rms = np.sqrt(want_v[k])
                held = rms > 1e-3 * rms.max()
                assert d[held].max(initial=0.0) <= 1e-5 * np.abs(want).max(), k
                assert d.max() <= 3 * lr_sum, k
    for outs in runs.ranks[1:]:
        for k in params:
            key = f"trainer_params/{k}"
            assert np.array_equal(outs[key], runs.ranks[0][key]), k


def _single_grads(cfg, seed, batch, grad_accum=1, skew_router=False, routes=None):
    """The single-process step's gradients (`make_train_step`, its AdamW
    update stubbed out) and metrics; `routes` collects the MoE routing."""
    from repro_torch.models import moe
    from repro_torch.optim import constant
    from repro_torch.train.train_step import make_train_step

    model = get_model(cfg)
    params = interop.params_from_numpy(_np_tree(model.specs(), seed, skew_router), "cpu")
    captured = {}

    def update(grads, opt, params, lr, acfg):
        captured["grads"] = grads
        return params, opt, torch.zeros(())

    import repro_torch.train.train_step as ts

    original, ts.adamw_update = ts.adamw_update, update
    top_k = moe._top_k
    if routes is not None:
        moe._top_k = lambda p, k: routes.append(top_k(p, k)) or routes[-1]
    try:
        step = make_train_step(model, constant(1e-3), grad_accum=grad_accum)
        state = {"params": params, "opt": {"count": torch.zeros((), dtype=torch.int32)},
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = step(state, batch)
    finally:
        ts.adamw_update, moe._top_k = original, top_k
    return captured["grads"], {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_global_routing_equals_single_process(runs, case):
    """Reduced OLMoE under `make_train_step(mesh=)` on 4 ranks routes the
    global batch: its loss, `lb_loss`, `router_z` and gradients equal the
    single-process step's within 1e-5 relative, with capacity drops (a
    skewed router at 512-token groups) and without (16 tokens: exact
    routing).  The backward recomputes the routing under `dots`, with its
    all-gather."""
    from repro_torch.models.moe import _capacity

    cfg = _moe_cfg()
    rows, seq = MOE_CASES[case]
    routes = []
    grads, metrics = _single_grads(cfg, 3, _moe_batch(rows, seq, 256), skew_router=True,
                                   routes=routes)
    cap = _capacity(rows * seq, seq, cfg.num_experts, cfg.num_experts_per_tok, 1.25)
    demand = max(int(torch.bincount(r.reshape(-1), minlength=cfg.num_experts).max())
                 for r in routes)
    assert (demand > cap) == (case == "drops"), (demand, cap)
    for found in runs.found:
        got = found[f"moe/{case}"]
        for k in ("loss", "lb_loss", "router_z", "accuracy"):
            assert got[k] == pytest.approx(metrics[k], rel=1e-5, abs=1e-7), k
    for key, want in tree_paths(grads):
        want = want.numpy()
        for outs in runs.ranks:
            assert np.abs(outs[f"moe/{case}/{key}"] - want).max() <= (
                1e-5 * np.abs(want).max() + 1e-12), key


@pytest.mark.parametrize("name", ["uneven", "accum"])
def test_dp_gradients_equal_single_process(runs, name):
    """6 rows over 4 ranks (2, 2, 1, 1: each rank weighted by its rows), and
    8 rows in 2 accumulated microbatches: the global gradients and loss of
    the single-process step within 1e-5."""
    rows, accum = {"uneven": (6, 1), "accum": (8, 2)}[name]
    grads, metrics = _single_grads(get_config("mesh-paper").reduced(), 4,
                                   _moe_batch(rows, 16, 256), grad_accum=accum)
    for found in runs.found:
        assert found[name]["loss"] == pytest.approx(metrics["loss"], rel=1e-5)
    for key, want in tree_paths(grads):
        want = want.numpy()
        for outs in runs.ranks:
            assert np.abs(outs[f"{name}/{key}"] - want).max() <= 1e-5 * np.abs(want).max(), key


def test_shard_of_and_gather_global(runs):
    for r, found in enumerate(runs.found):
        assert found["shard"] == {"spec": ["data", "model", None], "block": [2, 3, 3],
                                  "roundtrip": True, "replicated": True}, r


def test_failure_on_one_rank_restores_every_rank(runs):
    for found in runs.found:
        assert found["crash"] == {"restored": True, "bitwise": True}


def test_cli_local_dp_on_four_ranks(runs):
    """`--mesh local-dp` on the 4 ranks: every rank finishes 3 steps and,
    resumed from rank 0's checkpoint, a 4th; only rank 0 logs; the losses
    are the 1-rank CLI's."""
    from repro_torch.launch import train as ttrain

    assert runs.ckpts == ["step_00000002", "step_00000003", "step_00000004"]
    finals = []
    for r, found in enumerate(runs.found):
        lines = found["cli"].splitlines()
        done = [ln for ln in lines if ln.startswith("[done]")]
        assert len(done) == 2 and all(f"rank={r}/{WORLD}" in ln for ln in done), lines
        assert any("[resume] restoring step 3" in ln for ln in lines)
        assert any(ln.startswith("[step 3]") for ln in lines) == (r == 0)
        finals.append([ln.split("final_loss=")[1].split()[0] for ln in done])
    assert all(f == finals[0] for f in finals)
    one = io.StringIO()
    with redirect_stdout(one):
        ttrain.main(["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--mesh",
                     "local-dp", "--steps", "3", "--batch", "4", "--seq", "16"])
    got = float(one.getvalue().split("final_loss=")[1].split()[0])
    assert "rank=0/1" in one.getvalue()
    assert got == pytest.approx(float(finals[0][0]), rel=1e-4)


def test_cli_local_dp_through_torchrun_environment(tmp_path):
    """torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) with one
    rank: the launcher starts the gloo group and trains."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "mesh-paper", "--reduced", "--device", "cpu", "--mesh", "local-dp",
                          "--steps", "2", "--batch", "2", "--seq", "8"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "backend gloo" in res.stderr and "rank=0/1" in res.stdout
