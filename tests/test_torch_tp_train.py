"""Tensor-parallel training of the port against the reference under its own
mesh (`train_step.make_train_step(ctx=)`, the collectives' adjoint
backwards, `interop.ModelBlocks`, `optim.global_norm` on blocks, the
vocab-sharded `layers.softmax_xent`, `launch.train.build_trainer(mesh=)`,
checkpoints of a 'model' axis, `launch.mesh.make_production_mesh`).

Ranks, as in test_torch_tp.py: one reference subprocess with 4 virtual CPU
devices and one gloo group of 4 port ranks (a `file://` rendezvous in a
temporary directory), started together, each killed after SPAWN_TIMEOUT
s.  Both take each config's parameters from the reference's init
(`jax.random.PRNGKey(seed)`, through numpy into the port:
`interop.params_from_numpy`, then `shard_params` of the whole train state)
and the same numpy batch.  The reference runs its `make_train_step(...,
ctx=ShardCtx(make_local_mesh(shape, ("data", "model")), DEFAULT_RULES))`
and `jax.value_and_grad(model.loss)` under that ctx in one jit, with
`use_mesh_kernel=False` (its Pallas kernels do not lower under a mesh in
interpret mode); the port keeps `use_mesh_kernel=True` (the kernels' plain
versions on the CPU).  Its σ scramble (K3, Pallas) does not lower under a
mesh either, so the scrambled case is held against the reference's
one-device step.

Cases: reduced mesh-paper on 1x2, 1x4 (its 2 kv heads replicate under 4
query-head shards) and 2x2 with grad_accum 2; mesh-paper at d_model 256
and 256 tokens (the σ scramble fires) on 1x2; OLMoE at 16 experts on 1x4
(expert parallelism) and on 2x2 (its routing global over 'data' only,
`moe.global_routing`, beside EP over 'model'); Qwen1.5-MoE on 1x4 (the
hidden-dim branch, shared experts, the N = 1 gate); RWKV-6 and Zamba2 on 1x2 (Mamba2's B and C
segments, RWKV-6's sliced per-channel leaves); Whisper and Pixtral on
1x2, one gradient each against the port's single-process gradient.
Limits: each leaf's gathered gradient within 1e-5·max|ref| (f32; only the
order of the sums differs), the loss and the grad norm within 1e-5
relative; post-step parameters by test_torch_dp.py's rule; the replicated
leaves (and segments) bitwise equal across the 'model' ranks, every leaf
bitwise equal across the 'data' ranks.  The ranks also hold: the DP step
of `build_trainer(mesh=(2, 1))` (a ctx) bitwise `make_train_step(mesh=)`'s;
`global_norm` on blocks against the global tree's; the vocab-sharded
`softmax_xent` and its gradient against the whole one; each collective's
backward against its adjoint; a 1x2 trainer's checkpoint (the global tree)
and a single-process checkpoint restored onto 1x2.  In this process: the
1x2 checkpoint restored on one process, `--mesh prod` and
`make_production_mesh` on one process, the 'seq_sp' refusal, and
`interop.ModelBlocks`' replicated parts on hand-made layouts.
"""

import dataclasses
import hashlib
import io
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
TOKENS = 16  # tokens a row
LR = 1e-3
TOL = 1e-5
CKPT_STEPS = 2


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mesh: tuple
    seed: int = 0
    replace: tuple = ()  # config fields set on the reduced config
    rows: int = 2
    tokens: int = TOKENS
    grad_accum: int = 1
    ref: str = "mesh"  # mesh: the reference under its mesh; single: its one-device
    #                    step; port: the port's single-process gradient


CASES = {
    "mesh-paper-1x2": Case("mesh-paper", (1, 2)),
    "mesh-paper-1x4": Case("mesh-paper", (1, 4), 1),
    "mesh-paper-2x2-accum2": Case("mesh-paper", (2, 2), 2, rows=4, grad_accum=2),
    "sigma-1x2": Case("mesh-paper", (1, 2), 3, (("d_model", 256), ("head_dim", 64)),
                      tokens=256, ref="single"),
    "olmoe16-1x4": Case("olmoe-1b-7b", (1, 4), 4, (("num_experts", 16),)),
    "olmoe16-2x2": Case("olmoe-1b-7b", (2, 2), 10, (("num_experts", 16),)),
    "qwen2-moe-1x4": Case("qwen2-moe-a2.7b", (1, 4), 5),
    "rwkv-1x2": Case("rwkv6-1.6b", (1, 2), 6),
    "zamba-1x2": Case("zamba2-1.2b", (1, 2), 7),
    "whisper-1x2": Case("whisper-medium", (1, 2), 8, ref="port"),
    "pixtral-1x2": Case("pixtral-12b", (1, 2), 9, ref="port"),
}
STEP_CASES = [k for k, c in CASES.items() if c.ref != "port"]
# Leaves that must be in the per-parameter check by name: Mamba2's fused
# projection (B and C replicated inside it) and RWKV-6's per-channel
# parameters that the model code slices from replicated copies.
NAMED = {"zamba-1x2": ("mamba_seg/in_proj", "mamba_seg/conv_w", "mamba_seg/conv_b"),
         "rwkv-1x2": ("blocks/w0", "blocks/u", "blocks/ww2", "blocks/gn_g", "blocks/gn_b")}


def _cfg(get_config, case: Case):
    return dataclasses.replace(get_config(case.arch).reduced(), **dict(case.replace))


def _batch(cfg, case: Case):
    rng = np.random.default_rng(100 + case.seed)
    toks = rng.integers(0, cfg.vocab_size, size=(case.rows, case.tokens)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(case.rows, case.tokens * cfg.dec_ratio,
                                           cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(case.rows, cfg.num_stub_patches,
                                            cfg.d_model)).astype(np.float32)
    return batch


def _flat(tree, prefix):
    """{prefix/path: numpy f32} of a tree of arrays or tensors."""
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

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models import ShardCtx as JCtx
    from repro.models import get_model as jmodel
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim.schedules import constant as jconstant
    from repro.parallel.sharding import DEFAULT_RULES as JRULES
    from repro.train.train_step import make_train_step as jstep

    outs = {}
    for name, case in CASES.items():
        if case.ref == "port":
            continue
        cfg = dataclasses.replace(_cfg(jconfig, case), use_mesh_kernel=False)
        model = jmodel(cfg)
        params = model.init(jax.random.PRNGKey(case.seed))
        ctx = (JCtx(jmesh(case.mesh, ("data", "model")), JRULES) if case.ref == "mesh"
               else JCtx())
        step = jstep(model, jconstant(LR), JAdamW(), ctx, grad_accum=case.grad_accum)
        zeros = lambda t: jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), t)  # noqa: E731
        state = {"params": params, "opt": {"m": zeros(params), "v": zeros(params),
                                           "count": jnp.zeros((), jnp.int32)},
                 "step": jnp.zeros((), jnp.int32)}
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, case).items()}

        def grads_and_step(st, b, model=model, ctx=ctx, step=step, accum=case.grad_accum):
            vg = jax.value_and_grad(model.loss, has_aux=True)
            rows = b["tokens"].shape[0] // accum
            acc = None
            for i in range(accum):  # the reference step's microbatches, in order
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
                g = vg(st["params"], mb, ctx)[1]
                g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
                acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            return jax.tree.map(lambda x: x / accum, acc), step(st, b)

        grads, (new, met) = jax.jit(grads_and_step)(state, batch)
        outs.update(_flat(jax.tree.map(np.asarray, grads), f"{name}/grads"))
        outs.update(_flat(jax.tree.map(np.asarray, new["params"]), f"{name}/params"))
        outs.update(_flat(jax.tree.map(np.asarray, new["opt"]["v"]), f"{name}/v"))
        outs[f"{name}/loss"] = np.asarray(met["loss"])
        outs[f"{name}/grad_norm"] = np.asarray(met["grad_norm"])
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: 4 gloo ranks ------------------------------------------------------------


def _jax_params(case: Case):
    """The reference's init of `case` as numpy (this rank imports JAX)."""
    import jax

    from repro.configs import get_config as jconfig
    from repro.models import get_model as jmodel

    params = jmodel(_cfg(jconfig, case)).init(jax.random.PRNGKey(case.seed))
    return jax.tree.map(np.asarray, params)


def _state(params):
    from repro_torch.optim import adamw_init

    return {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}


def _replicated_sha(tree, blocks):
    """{path: sha256 of the leaf's replicated parts} of a tree of blocks."""
    from repro_torch.tree import tree_leaves, tree_paths

    out = {}
    for (path, leaf), rep in zip(tree_paths(tree), tree_leaves(blocks.replicated)):
        same = blocks._parts(leaf.detach(), rep)[1]
        if same:
            h = hashlib.sha256()
            for v in same:
                h.update(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
            out[path] = h.hexdigest()
    return out


def _sha_all(tree):
    from repro_torch.tree import tree_paths

    return {p: hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8).numpy()
                              .tobytes()).hexdigest() for p, t in tree_paths(tree)}


def _collective_adjoints(rank, group, found):
    """Each collective's backward against its adjoint on the CPU group:
    the loss sum(y * w_r), w different on every rank, so the gradient of
    x is the adjoint applied to the ranks' w (written out by hand)."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as col

    n, idx = dist.get_world_size(group), dist.get_rank(group)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(30)
        xs = [torch.randn(4, 6, generator=g).to(dtype) for _ in range(n)]
        ws = [torch.randn(4, 6, generator=g).to(dtype) for _ in range(n)]
        wide = [torch.randn(4, 6 * n, generator=g).to(dtype) for _ in range(n)]
        f32_sum = lambda ts: torch.stack([t.float() for t in ts]).sum(0)  # noqa: E731
        x = xs[idx].clone().requires_grad_(True)
        y = col.all_reduce(x, group=group)
        (y.float() * ws[idx].float()).sum().backward()
        res[f"all_reduce {dtype}"] = (bool(torch.equal(y, f32_sum(xs).to(dtype)))
                                      if dtype == torch.float32 else True) and bool(
            torch.equal(x.grad, f32_sum(ws).to(dtype)))
        x = xs[idx].clone().requires_grad_(True)
        y = col.all_gather(x, 1, group)
        (y.float() * wide[idx].float()).sum().backward()
        want = f32_sum(wide)[:, idx * 6:(idx + 1) * 6].to(dtype)
        res[f"all_gather {dtype}"] = bool(torch.equal(y, torch.cat(xs, 1))) and bool(
            torch.equal(x.grad, want))
        x = wide[idx].clone().requires_grad_(True)
        y = col.reduce_scatter(x, 1, group)
        (y.float() * ws[idx].float()).sum().backward()
        res[f"reduce_scatter {dtype}"] = bool(torch.equal(x.grad, torch.cat(ws, 1))) and (
            dtype != torch.float32
            or bool(torch.equal(y, f32_sum(wide)[:, idx * 6:(idx + 1) * 6])))
        # MAX carries no gradient.
        x = xs[idx].clone().requires_grad_(True)
        res[f"max {dtype}"] = not col.all_reduce(x, dist.ReduceOp.MAX, group).requires_grad
    found["adjoints"] = res


def _xent_check(group_mesh, found):
    """The vocab-sharded softmax_xent against the whole one on 2 ranks:
    loss, accuracy (ties on the global argmax) and the logits' gradient,
    padded columns at -1e30."""
    from repro_torch.models.layers import ShardCtx, softmax_xent

    ctx = ShardCtx(group_mesh)
    vocab = 40
    g = torch.Generator().manual_seed(31)
    logits = torch.randn(2, 6, vocab, generator=g)
    logits[..., 37:] = -1e30  # padded vocab columns
    logits[0, 0, 3] = logits[0, 0, 25] = 9.0  # a tie across the ranks: index 3 wins
    logits[0, 1, 21] = logits[0, 1, 30] = 9.0  # a tie on rank 1: index 21 wins
    labels = torch.randint(0, 37, (2, 6), generator=g)
    labels[0, 0], labels[0, 1] = 3, 21
    whole = logits.clone().requires_grad_(True)
    loss_w, acc_w = softmax_xent(whole, labels)
    loss_w.backward()
    part = ctx.part("vocab", vocab)
    mine = logits[..., part.start:part.start + part.size].clone().requires_grad_(True)
    loss_s, acc_s = softmax_xent(mine, labels, part, ctx)
    (loss_s / part.count).backward()  # the 1/M seed: the loss is replicated
    grad = ctx.gather(mine.grad, ("batch", "seq", "vocab"), (2, 6, vocab))
    found["xent"] = dict(loss=[float(loss_s), float(loss_w)], acc=[float(acc_s), float(acc_w)],
                         grad_err=float((grad - whole.grad).abs().max()),
                         grad_scale=float(whole.grad.abs().max()))


def _rank_main(rank, world, init_file, out_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.models.layers import ShardCtx
    from repro_torch.optim import AdamWConfig, constant, global_norm
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.train.loop import LoopConfig, restore_state, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_paths

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    meshes = {shape: make_local_mesh(shape, ("data", "model"))
              for shape in sorted({c.mesh for c in CASES.values()} | {(2, 1)})}
    outs, found = {}, {}
    for name, case in CASES.items():
        if rank >= case.mesh[0] * case.mesh[1]:
            continue
        cfg = dataclasses.replace(_cfg(get_config, case), use_mesh_kernel=True)
        model = get_model(cfg)
        full = interop.params_from_numpy(_jax_params(case), "cpu")
        ctx = ShardCtx(meshes[case.mesh], DEFAULT_RULES)
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, case).items()}
        step = make_train_step(model, constant(LR), AdamWConfig(), ctx,
                               grad_accum=case.grad_accum)
        blocks = step.blocks
        state = interop.shard_params(_state(full), model, ctx)
        grads, met = step.grads(state["params"], batch)
        outs.update(_flat(blocks.gather(grads), f"{name}/grads"))
        outs[f"{name}/loss"] = np.asarray(float(met["loss"]))
        found[f"{name}/grads_sha"] = _replicated_sha(grads, blocks)
        found[f"{name}/norm"] = [float(global_norm(grads, blocks)),
                                 float(global_norm(blocks.gather(grads)))]
        found[f"{name}/replicated"] = {p: r if r in (True, None) else [r[0], list(r[1])]
                                       for p, r in tree_paths(blocks.replicated)}
        if case.ref == "port":
            if rank == 0:
                single = make_train_step(model, constant(LR), AdamWConfig())
                outs.update(_flat(single.grads(full, batch)[0], f"{name}/single"))
            continue
        state, met = step(state, batch)
        outs[f"{name}/grad_norm"] = np.asarray(float(met["grad_norm"]))
        outs.update(_flat(blocks.gather(state["params"]), f"{name}/params"))
        found[f"{name}/params_sha"] = _replicated_sha(state["params"], blocks)
        found[f"{name}/all_sha"] = _sha_all(state["params"])

    # build_trainer(mesh=(2, 1)) trains under a ctx: its DP gradients bitwise
    # those of make_train_step(mesh=), the data-parallel callers' form.
    if rank < 2:
        cfg = get_config("mesh-paper").reduced()
        step, state, data = build_trainer(cfg, batch=4, seq=TOKENS, mesh=meshes[(2, 1)],
                                          lr=LR, total_steps=4, device="cpu")
        batch = next(data)
        g_ctx, m_ctx = step.grads(state["params"], batch)
        plain = make_train_step(get_model(cfg), constant(LR), AdamWConfig(),
                                mesh=meshes[(2, 1)])
        g_mesh, m_mesh = plain.grads(state["params"], batch)
        found["dp_bitwise"] = (all(torch.equal(a, b) for (_, a), (_, b) in
                                   zip(tree_paths(g_ctx), tree_paths(g_mesh)))
                               and float(m_ctx["loss"]) == float(m_mesh["loss"]))

    # Checkpoints on 1x2: a single-process checkpoint restored onto 1x2, and
    # build_trainer's 1x2 trainer through train_loop (the global tree written).
    if rank < 2:
        mesh = meshes[(1, 2)]
        group = mesh.get_group("model")
        cfg = get_config("mesh-paper").reduced()
        step, state, data = build_trainer(cfg, batch=2, seq=TOKENS, mesh=mesh, lr=LR,
                                          total_steps=CKPT_STEPS, device="cpu")
        single_dir = os.path.join(out_dir, "ckpt_single")
        full = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        if rank == 0:
            CheckpointManager(single_dir).save(1, _state(full), {"data_step": 0})
        dist.barrier(group)
        restored = restore_state(CheckpointManager(single_dir), 1, state, step.blocks)
        want = interop.shard_params(_state(full), get_model(cfg), ShardCtx(mesh, DEFAULT_RULES))
        found["restore_onto_1x2"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(tree_paths(restored), tree_paths(want)))
        logger = MetricsLogger(stream=None if rank == 0 else io.StringIO())
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt_1x2"))
        state = train_loop(step, state, data, LoopConfig(total_steps=CKPT_STEPS, ckpt_every=1,
                                                         log_every=1),
                           ckpt=ckpt, logger=logger, group=[group], blocks=step.blocks)
        outs.update(_flat(step.blocks.gather(state), "ckpt_state"))
        found["ckpt_losses"] = [h["loss"] for h in logger.history]
        # The same trainer's loss on one process (the first step).
        one, st1, d1 = build_trainer(cfg, batch=2, seq=TOKENS, lr=LR, total_steps=CKPT_STEPS,
                                     device="cpu")
        found["single_loss"] = float(one(st1, next(d1))[1]["loss"])

    if rank < 2:
        _collective_adjoints(rank, meshes[(1, 2)].get_group("model"), found)
        _xent_check(meshes[(1, 2)], found)

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

    out = tmp_path_factory.mktemp("tp_train")
    paths = (str(ROOT / "src"), str(ROOT / "tests"))
    env = forced_device_env(WORLD, pythonpath=paths)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_tp_train as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
    rank_env.pop("XLA_FLAGS", None)
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_tp_train as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    return types.SimpleNamespace(
        dir=out, ref=dict(np.load(out / "reference.npz")),
        ranks=[dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
        found=[json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)])


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(initial=0.0), np.abs(want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: max |d| {err} > {tol} x max|ref| {scale}"


def _ranks_of(case):
    return range(CASES[case].mesh[0] * CASES[case].mesh[1])


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_gradients_match_reference(runs, case):
    """Each leaf's gradient, gathered from the ranks' blocks, within
    1e-5·max|ref| of the reference's under its mesh (or its one-device
    step, or for Whisper and Pixtral the port's single-process step)."""
    c = CASES[case]
    want = (_sub(runs.ranks[0], f"{case}/single/") if c.ref == "port"
            else _sub(runs.ref, f"{case}/grads/"))
    assert want
    for k in NAMED.get(case, ()):
        assert k in want, k
    for r in _ranks_of(case):
        got = _sub(runs.ranks[r], f"{case}/grads/")
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], what=f"rank {r} {k}")


@pytest.mark.parametrize("case", STEP_CASES)
def test_loss_and_grad_norm_match_reference(runs, case):
    for r in _ranks_of(case):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(runs.ranks[r][f"{case}/{key}"], runs.ref[f"{case}/{key}"],
                                       rtol=TOL, atol=0)


@pytest.mark.parametrize("case", STEP_CASES)
def test_post_step_parameters_match_reference(runs, case):
    """test_torch_dp.py's rule: within 1e-5·max|ref| where AdamW's step is
    well-conditioned, and within 3x the lr elsewhere.  Well-conditioned is
    that rule's sqrt(v) above 1e-3 of the leaf's largest, and here also
    AdamW's eps (1e-8) under 1 % of the bias-corrected sqrt(v) (|g| after
    one step): a step g / (|g| + eps) moves by eps/|g| times the gradient's
    relative difference, so where |g| nears eps (Qwen1.5-MoE's k bias: |g|
    down to 1e-7, whose 1.2e-10 gradient difference is within the 1e-5
    limit) the update follows rounding.  test_torch_dp.py's mesh-paper has
    no such leaf."""
    b2 = 0.95  # AdamWConfig's: v after one step is (1 - b2) g^2
    want_p, want_v = _sub(runs.ref, f"{case}/params/"), _sub(runs.ref, f"{case}/v/")
    for r in _ranks_of(case):
        got = _sub(runs.ranks[r], f"{case}/params/")
        assert got.keys() == want_p.keys()
        for k, want in want_p.items():
            d = np.abs(got[k] - want)
            rms = np.sqrt(want_v[k])
            held = (rms > 1e-3 * rms.max()) & (rms / np.sqrt(1 - b2) > 100 * 1e-8)
            assert d[held].max(initial=0.0) <= TOL * np.abs(want).max(), (r, k)
            assert d.max() <= 3 * LR, (r, k)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_bitwise_across_model_ranks(runs, case):
    """The replicated leaves' (and segments') gradients, after the sum over
    'model', and after the step their parameters, are bitwise equal on the
    'model' ranks of each data rank; every parameter leaf is bitwise equal
    across the 'data' ranks."""
    d, m = CASES[case].mesh
    for key in ("grads_sha",) + (("params_sha",) if case in STEP_CASES else ()):
        for dr in range(d):
            first = runs.found[dr * m][f"{case}/{key}"]
            assert first, "no replicated leaf recorded"
            for r in range(dr * m + 1, (dr + 1) * m):
                assert runs.found[r][f"{case}/{key}"] == first, (key, r)
    if d > 1 and case in STEP_CASES:
        for r in range(m, d * m):
            assert runs.found[r][f"{case}/all_sha"] == runs.found[r % m][f"{case}/all_sha"], r


def test_replicated_parts_are_the_expected_leaves(runs):
    """Norms replicate whole; Mamba2's in_proj / conv_w / conv_b hold B and
    C as replicated ranges beside the rank's heads; RWKV-6's per-channel
    leaves replicate whole; kv heads that do not divide 'model' (1x4)
    replicate; sharded weights are this rank's own."""
    rep = runs.found[0]
    mp, mp4 = rep["mesh-paper-1x2/replicated"], rep["mesh-paper-1x4/replicated"]
    assert mp["blocks/ln1"] is True and mp["final_norm"] is True
    assert mp["blocks/attn/wk"] is None and mp4["blocks/attn/wk"] is True
    assert mp4["blocks/attn/wq"] is None and mp["embed"] is None
    z = rep["zamba-1x2/replicated"]
    for k in NAMED["zamba-1x2"]:
        _, ranges = z[k]
        assert len(ranges) == 2, k  # B and C
    assert z["mamba_seg/out_proj"] is None and z["mamba_seg/a_log"] is True
    rw = rep["rwkv-1x2/replicated"]
    assert all(rw[k] is True for k in NAMED["rwkv-1x2"]) and rw["blocks/wr"] is None
    ol = rep["olmoe16-1x4/replicated"]
    assert ol["blocks/moe/router"] is True and ol["blocks/moe/wi"] is None
    qm = rep["qwen2-moe-1x4/replicated"]
    assert qm["blocks/moe/shared_gate"] is True and qm["blocks/moe/shared_wi"] is None


def test_global_norm_on_blocks(runs):
    """`global_norm(blocks_tree, blocks)` against the gathered tree's norm,
    equal on every rank."""
    for case in CASES:
        vals = [runs.found[r][f"{case}/norm"] for r in _ranks_of(case)]
        for on_blocks, whole in vals:
            np.testing.assert_allclose(on_blocks, whole, rtol=1e-6)
        assert len({v[0] for v in vals}) == 1, case


def test_dp_only_trainer_is_bitwise_the_mesh_step(runs):
    """build_trainer(mesh=(2, 1)) passes a ctx whose 'model' axis has one
    rank: its gradients and loss are bitwise make_train_step(mesh=)'s."""
    assert runs.found[0]["dp_bitwise"] is True and runs.found[1]["dp_bitwise"] is True


def test_vocab_sharded_xent_matches_whole(runs):
    for r in range(2):
        x = runs.found[r]["xent"]
        np.testing.assert_allclose(x["loss"][0], x["loss"][1], rtol=1e-6)
        assert x["acc"][0] == x["acc"][1]
        assert x["grad_err"] <= 1e-6 * x["grad_scale"]


def test_collective_backwards_are_their_adjoints(runs):
    for r in range(2):
        res = runs.found[r]["adjoints"]
        assert len(res) == 8 and all(res.values()), res


def test_checkpoint_across_meshes(runs):
    """A single-process checkpoint restored onto 1x2 is bitwise each rank's
    blocks; the 1x2 trainer's checkpoint (the global tree, written by rank
    0) restores on one process bitwise equal to the state the ranks
    gathered, and its first loss is the single-process trainer's within
    1e-5."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train.train_step import init_train_state

    for r in range(2):
        assert runs.found[r]["restore_onto_1x2"] is True
        np.testing.assert_allclose(runs.found[r]["ckpt_losses"][0], runs.found[r]["single_loss"],
                                   rtol=TOL)
    ckpt = CheckpointManager(str(runs.dir / "ckpt_1x2"))
    assert ckpt.latest_step() == CKPT_STEPS
    model = get_model(get_config("mesh-paper").reduced())
    like = init_train_state(model, torch.Generator().manual_seed(1), "cpu")
    restored = _sub(_flat(ckpt.restore(CKPT_STEPS, like), "ckpt_state"), "ckpt_state/")
    for r in range(2):
        got = _sub(runs.ranks[r], "ckpt_state/")
        assert got.keys() == restored.keys()
        for k, v in restored.items():
            assert np.array_equal(got[k], v), k


# -- in this process -----------------------------------------------------------------


def test_prod_mesh_needs_256_ranks():
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import PROD_TP, make_production_mesh

    assert PROD_TP == 16
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="256 ranks; the process group has 1"):
        ttrain.main(["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--mesh", "prod"])


def _fake_ctx(model_size, coord, rules=None):
    """A ShardCtx on a plain (data 1, model n) layout placed at `coord`."""
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import MeshLayout

    shape = {"data": 1, "model": model_size}
    lay = MeshLayout(shape, {"data": 0, "model": coord},
                     np.arange(model_size).reshape(1, model_size))
    return ShardCtx(tuple(shape.items()), rules, lay)


def test_seq_sp_still_refused():
    """Once the refusal of the 'seq_sp' rule (Megatron sequence
    parallelism), which the port now runs (tests/test_torch_sp.py holds its
    gradients on ranks): a layer's carrier under 'seq_sp' on 'model' is
    the rank's block of the sequence, a T that does not divide the axis
    replicates, and `seq_whole` leaves a whole sequence as it is."""
    from repro_torch.models.layers import Part
    from repro_torch.models.transformer import seq_whole
    from repro_torch.parallel.sharding import DEFAULT_RULES

    ctx = _fake_ctx(2, 1, DEFAULT_RULES.replace(seq_sp="model"))
    x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    assert torch.equal(ctx.c(x, ("batch", "seq_sp", "embed"), (None, 8, 4)), x[:, 4:])
    assert ctx.part("seq_sp", 8) == Part(4, 4, 2, "model")
    assert ctx.part("seq_sp", 7).count == 1
    assert seq_whole(x, ctx, 8) is x


def test_block_pieces_and_replicated_ranges():
    """`block_pieces` of a flat split, an indivisible dim and a whole dim,
    and `replicated_ranges` of Mamba2's fused in_proj on a hand-made
    1x2 layout: rank r holds its heads' z, x and dt and B and C whole."""
    from repro_torch.configs import get_config
    from repro_torch.interop import _leaf_pieces
    from repro_torch.parallel.sharding import (
        DEFAULT_RULES,
        block_pieces,
        replicated_ranges,
    )

    ctx = _fake_ctx(2, 1)
    lay = ctx._resolved[2]
    assert block_pieces((8, 6), ("vocab", "embed"), ctx.mesh, DEFAULT_RULES, lay) == (
        ((4, 4, "model"),), ((0, 6, None),))
    assert block_pieces((7,), ("vocab",), ctx.mesh, DEFAULT_RULES, lay) == (((0, 7, None),),)
    assert replicated_ranges((((0, 7, None),),), "model") is True
    assert replicated_ranges((((4, 4, "model"),), ((0, 6, None),)), "model") is None
    cfg = get_config("zamba2-1.2b").reduced()
    d_in, n, h = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_size, cfg.ssm_num_heads
    pieces = _leaf_pieces((cfg.d_model, 2 * d_in + 2 * n + h), ("embed", "mlp"), "in_proj",
                          cfg, ctx)
    half = d_in // 2
    assert [p[:2] for p in pieces[1]] == [(half, half), (d_in + half, half), (2 * d_in, n),
                                          (2 * d_in + n, n), (2 * d_in + 2 * n + h // 2, h // 2)]
    assert replicated_ranges(pieces, "model") == (1, ((2 * half, n), (2 * half + n, n)))
