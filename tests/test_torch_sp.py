"""Megatron sequence parallelism ('seq_sp', `TRAIN_RULES`), FSDP parameter
rules (`PARAM_RULES`) and `grad_accum` as a config field: the port's
training under them against the reference's under its own mesh.

Spawn pattern of test_torch_tp_train.py: one reference subprocess with 4
virtual CPU devices and one gloo group of 4 port ranks (a `file://`
rendezvous), started together, each killed after SPAWN_TIMEOUT s.  Both
take each config's parameters from the reference's init (through numpy
into the port, then `interop.shard_params` of the whole train state under
the case's ctx) and the same numpy batch.  The reference builds its step
from its own `make_train_step(..., ctx=ShardCtx(mesh, rules),
grad_accum=cfg.grad_accum)` and jits it with the state's shardings from
its `tree_shardings` under the parameter rules (`PARAM_RULES` for FSDP,
else the activation rules), `use_mesh_kernel=False`; its gradients are
`jax.value_and_grad(model.loss)` under the same ctx, microbatch by
microbatch, in the same jit.  The port keeps `use_mesh_kernel=True` (the
kernels' plain versions on the CPU).

Cases: every training family under `TRAIN_RULES` on 1x2 (mesh-paper,
OLMoE, RWKV-6, Zamba2, Whisper, Pixtral: each layer's carrier is the
rank's half of the sequence, gathered where the next layer reads it);
mesh-paper and OLMoE on 2x2 under `TRAIN_RULES` with `PARAM_RULES`
parameters (each leaf's 'embed' dim also cut over 'data'); mesh-paper on
2x2 with FSDP and the config's `grad_accum` 4 against the reference's
`grad_accum=4`, the port's step built by `build_trainer` from that field.
Limits: each leaf's gradient, gathered from the ranks' blocks
(`ModelBlocks.gather`: over 'data', then 'model'), within 1e-5·max|ref|;
the loss and the grad norm within 1e-5 relative.  The ranks also record,
under `full` remat on 1x2, the carrier each layer's checkpoint saves:
the rank's (rows, T/2, D) block.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 300
TOKENS = 16
LR = 1e-3
TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mesh: tuple
    seed: int = 0
    fsdp: bool = False
    rows: int = 2
    grad_accum: int = 1


CASES = {
    "mesh-paper-sp-1x2": Case("mesh-paper", (1, 2), 0),
    "olmoe-sp-1x2": Case("olmoe-1b-7b", (1, 2), 1),
    "rwkv-sp-1x2": Case("rwkv6-1.6b", (1, 2), 2),
    "zamba-sp-1x2": Case("zamba2-1.2b", (1, 2), 3),
    "whisper-sp-1x2": Case("whisper-medium", (1, 2), 4),
    "pixtral-sp-1x2": Case("pixtral-12b", (1, 2), 5),
    "mesh-paper-fsdp-2x2": Case("mesh-paper", (2, 2), 6, fsdp=True, rows=4),
    "olmoe-fsdp-2x2": Case("olmoe-1b-7b", (2, 2), 7, fsdp=True, rows=4),
    "mesh-paper-fsdp-2x2-accum4": Case("mesh-paper", (2, 2), 8, fsdp=True, rows=8,
                                       grad_accum=4),
}


def _cfg(get_config, case: Case):
    return dataclasses.replace(get_config(case.arch).reduced(), grad_accum=case.grad_accum)


def _batch(cfg, case: Case):
    rng = np.random.default_rng(200 + case.seed)
    toks = rng.integers(0, cfg.vocab_size, size=(case.rows, TOKENS)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(case.rows, TOKENS * cfg.dec_ratio,
                                           cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(case.rows, cfg.num_stub_patches,
                                            cfg.d_model)).astype(np.float32)
    return batch


def _flat(tree, prefix):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:
            a = node.detach().float().numpy() if isinstance(node, torch.Tensor) else node
            out[path] = np.asarray(a, np.float32)

    walk(tree, prefix)
    return out


# -- the reference: one subprocess with 4 virtual devices ---------------------------


def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models import ShardCtx as JCtx
    from repro.models import get_model as jmodel
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim.schedules import constant as jconstant
    from repro.parallel.sharding import PARAM_RULES as JPARAM
    from repro.parallel.sharding import TRAIN_RULES as JTRAIN
    from repro.parallel.sharding import tree_shardings as jshardings
    from repro.train.train_step import make_train_step as jstep

    outs = {}
    for name, case in CASES.items():
        cfg = dataclasses.replace(_cfg(jconfig, case), use_mesh_kernel=False)
        model = jmodel(cfg)
        params = model.init(jax.random.PRNGKey(case.seed))
        mesh = jmesh(case.mesh, ("data", "model"))
        ctx = JCtx(mesh, JTRAIN)
        step = jstep(model, jconstant(LR), JAdamW(), ctx, grad_accum=cfg.grad_accum)
        zeros = lambda t: jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), t)  # noqa: E731
        state = {"params": params, "opt": {"m": zeros(params), "v": zeros(params),
                                           "count": jnp.zeros((), jnp.int32)},
                 "step": jnp.zeros((), jnp.int32)}
        prules = JPARAM if case.fsdp else JTRAIN
        p_sh = jshardings(model.logical_axes(), mesh, prules, params)
        rep = NamedSharding(mesh, JP())
        state_sh = {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "count": rep}, "step": rep}
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, case).items()}

        def grads_and_step(st, b, model=model, ctx=ctx, step=step, accum=cfg.grad_accum):
            vg = jax.value_and_grad(model.loss, has_aux=True)
            rows = b["tokens"].shape[0] // accum
            acc = None
            for i in range(accum):  # the reference step's microbatches, in order
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
                g = jax.tree.map(lambda x: x.astype(jnp.float32), vg(st["params"], mb, ctx)[1])
                acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            return jax.tree.map(lambda x: x / accum, acc), step(st, b)

        grads, (_, met) = jax.jit(grads_and_step, in_shardings=(state_sh, None))(state, batch)
        outs.update(_flat(jax.tree.map(np.asarray, grads), f"{name}/grads"))
        outs[f"{name}/loss"] = np.asarray(met["loss"])
        outs[f"{name}/grad_norm"] = np.asarray(met["grad_norm"])
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: 4 gloo ranks ------------------------------------------------------------


def _jax_params(case: Case):
    import jax

    from repro.configs import get_config as jconfig
    from repro.models import get_model as jmodel

    params = jmodel(_cfg(jconfig, case)).init(jax.random.PRNGKey(case.seed))
    return jax.tree.map(np.asarray, params)


def _rank_main(rank, world, init_file, out_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model, transformer
    from repro_torch.models.layers import ShardCtx
    from repro_torch.optim import AdamWConfig, adamw_init, constant
    from repro_torch.parallel.sharding import PARAM_RULES, TRAIN_RULES
    from repro_torch.train.train_step import make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    meshes = {shape: make_local_mesh(shape, ("data", "model"))
              for shape in sorted({c.mesh for c in CASES.values()})}
    outs, found = {}, {}
    for name, case in CASES.items():
        if rank >= case.mesh[0] * case.mesh[1]:
            continue
        cfg = dataclasses.replace(_cfg(get_config, case), use_mesh_kernel=True)
        model = get_model(cfg)
        full = interop.params_from_numpy(_jax_params(case), "cpu")
        prules = PARAM_RULES if case.fsdp else None
        ctx = ShardCtx(meshes[case.mesh], TRAIN_RULES, param_rules=prules)
        if case.grad_accum > 1:  # the step from the config's field, as the trainer builds it
            step = build_trainer(cfg, batch=case.rows, seq=TOKENS, mesh=meshes[case.mesh],
                                 lr=LR, total_steps=4, device="cpu", rules=TRAIN_RULES,
                                 param_rules=prules)[0]
        else:
            step = make_train_step(model, constant(LR), AdamWConfig(), ctx)
        state = interop.shard_params({"params": full, "opt": adamw_init(full),
                                      "step": torch.zeros((), dtype=torch.int32)}, model, ctx)
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, case).items()}
        grads, met = step.grads(state["params"], batch)
        outs.update(_flat(step.blocks.gather(grads), f"{name}/grads"))
        outs[f"{name}/loss"] = np.asarray(float(met["loss"]))
        _, met = step(state, batch)
        outs[f"{name}/grad_norm"] = np.asarray(float(met["grad_norm"]))
        found[f"{name}/blocks"] = [list(t.shape) for t in
                                   (state["params"]["final_norm"], state["opt"]["m"]["embed"])]

    # The carrier the checkpoint of each layer saves under `full` remat.
    if rank < 2:
        saved, run = [], transformer.checkpoint

        def spy(fn, *args, **kw):
            saved.append(list(args[0].shape))
            return run(fn, *args, **kw)

        transformer.checkpoint = spy
        cfg = dataclasses.replace(get_config("mesh-paper").reduced(), remat_policy="full")
        model = get_model(cfg)
        ctx = ShardCtx(meshes[(1, 2)], TRAIN_RULES)
        full = model.init(torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(model, constant(LR), AdamWConfig(), ctx)
        toks = torch.randint(0, cfg.vocab_size, (2, TOKENS), generator=torch.Generator())
        step.grads(interop.shard_params(full, model, ctx), {"tokens": toks, "labels": toks})
        transformer.checkpoint = run
        found["saved"] = saved
        found["saved_want"] = [[2, TOKENS // 2, cfg.d_model]] * cfg.num_layers

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
    pytest.importorskip("jax")
    from repro.launch.mesh import forced_device_env

    out = tmp_path_factory.mktemp("sp")
    paths = (str(ROOT / "src"), str(ROOT / "tests"))
    env = forced_device_env(WORLD, pythonpath=paths)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_sp as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
    rank_env.pop("XLA_FLAGS", None)
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_sp as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    return types.SimpleNamespace(
        ref=dict(np.load(out / "reference.npz")),
        ranks=[dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
        found=[json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)])


def _ranks_of(case):
    return range(CASES[case].mesh[0] * CASES[case].mesh[1])


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_gradients_match_reference(runs, case):
    want = _sub(runs.ref, f"{case}/grads/")
    assert want
    for r in _ranks_of(case):
        got = _sub(runs.ranks[r], f"{case}/grads/")
        assert got.keys() == want.keys()
        for k in want:
            err, scale = np.abs(got[k] - want[k]).max(), np.abs(want[k]).max()
            assert err <= TOL * scale, f"rank {r} {k}: max |d| {err} > {TOL} x {scale}"


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_norm_match_reference(runs, case):
    for r in _ranks_of(case):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(runs.ranks[r][f"{case}/{key}"], runs.ref[f"{case}/{key}"],
                                       rtol=TOL, atol=0)


@pytest.mark.parametrize("case", [k for k, c in CASES.items() if c.fsdp])
def test_fsdp_state_is_the_data_model_block(runs, case):
    """Under FSDP a rank holds its 'data' block of every 'embed' dim: the
    final norm's (d_model / D,) and the embedding's moment (V / M, d / D)."""
    from repro_torch.configs import get_config

    c = CASES[case]
    d, m = c.mesh
    cfg = _cfg(get_config, c)
    for r in _ranks_of(case):
        norm, emb = runs.found[r][f"{case}/blocks"]
        assert norm == [cfg.d_model // d]
        assert emb == [cfg.vocab_size // m, cfg.d_model // d]


def test_saved_carrier_is_the_ranks_sequence_block(runs):
    for r in range(2):
        assert runs.found[r]["saved"] == runs.found[r]["saved_want"]
