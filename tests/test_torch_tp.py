"""Tensor-parallel serving of the port against the reference under its own
mesh (`models.layers.ShardCtx`, `parallel.sharding.constrain`,
`interop.shard_params`, the models' `ctx`, `serving_steps` / `generate` /
`ContinuousBatchingServer` under a mesh, `serve --mesh`, K6's `q_offset`).

Ranks: one reference subprocess with 4 virtual CPU devices and one gloo
group of 4 port ranks (a `file://` rendezvous in a temporary directory),
started together.  Both take each config's parameters from the reference's
init (`jax.random.PRNGKey(seed)`, through numpy into the port:
`interop.params_from_numpy`, then `shard_params`) and the same numpy
inputs.  The reference runs its jitted steps under
`ShardCtx(make_local_mesh(shape, ("data", "model")), rules)` with
`use_mesh_kernel=False`: its Pallas kernels do not lower under a mesh in
interpret mode on the CPU, and its own `layers.gemm` docstring says its XLA
backend is what runs under pjit.  The port keeps the kernel path
(`use_mesh_kernel=True`: the kernels' plain versions on the CPU, the row
products' f32 partials through the planner).  Limits: logits and caches
within 1e-5·max|ref| (f32; only the order of the sums differs), greedy
tokens equal.

Cases: mesh-paper on 1x2, 1x4 (its 2 kv heads replicate under 4 query-head
shards) and 2x2 (prefill logits and caches, 8 dense and 8 paged decode
steps, `generate`'s tokens); OLMoE at 16 experts (expert parallelism) and
Qwen1.5-MoE (the hidden-dim branch, shared experts) on 1x4 (prefill
logits, aux losses, every routing decision equal across the ranks);
Qwen2-7B with attn_chunk 8 and the 'seq_attn' rule on 'model' on 1x4 (the
context-parallel chunked prefill: K6's plain version at a query offset),
and on 1x2 at 3 query heads over 1 kv head, which replicate (prefill
logits and caches, also against the port's single-process prefill);
Pixtral on 1x2.  The port's ranks also run: RWKV-6, Zamba2 and Whisper's
prefill step on 1x2 and 2x1 (test_torch_tp_families.py holds them against
the reference); the continuous-batching server on 1x2 and 2x1 against the
single-process server; `serve --mesh 1x2`.  In this process: the serve report's sharding column,
`constrain` / `ShardCtx.c` without a mesh, first-wins, the gate/up split of
`shard_params` against a hand-sliced tree, and `q_offset`.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 300
PROMPT, STEPS, PAGE = 16, 8, 8  # mesh-paper: prompt tokens, decode steps, page size
ROWS = 2  # batch rows of every case
TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mesh: tuple
    seed: int = 0
    replace: tuple = ()  # config fields set on the reduced config
    seq_attn: bool = False  # DEFAULT_RULES.replace(seq_attn="model")
    tokens: int = PROMPT
    decode: bool = False  # dense and paged decode, generate
    aux: bool = False  # the MoE aux losses of `forward`


CASES = {
    "mesh-paper-1x2": Case("mesh-paper", (1, 2), decode=True),
    "mesh-paper-1x4": Case("mesh-paper", (1, 4), decode=True),
    "mesh-paper-2x2": Case("mesh-paper", (2, 2), decode=True),
    "olmoe16-1x4": Case("olmoe-1b-7b", (1, 4), seed=1, replace=(("num_experts", 16),), aux=True),
    "qwen2-moe-1x4": Case("qwen2-moe-a2.7b", (1, 4), seed=2, aux=True),
    "qwen2-seq-attn-1x4": Case("qwen2-7b", (1, 4), seed=3, replace=(("attn_chunk", 8),),
                               seq_attn=True, tokens=32),
    # 3 query heads over 1 kv head do not divide 'model': the heads replicate
    # and 'seq_attn' alone takes the axis (context parallelism all the same).
    "qwen2-seq-attn-3h-1x2": Case("qwen2-7b", (1, 2), seed=5,
                                  replace=(("attn_chunk", 8), ("num_heads", 3),
                                           ("num_kv_heads", 1)), seq_attn=True, tokens=32),
    "pixtral-1x2": Case("pixtral-12b", (1, 2), seed=4),
}
DECODE_CASES = [k for k, c in CASES.items() if c.decode]
SEQ_ATTN_CASES = [k for k, c in CASES.items() if c.seq_attn]
AUX_CASES = [k for k, c in CASES.items() if c.aux]
UNTP = ("rwkv6-1.6b", "zamba2-1.2b", "whisper-medium")


def _cfg(get_config, case: Case):
    return dataclasses.replace(get_config(case.arch).reduced(), **dict(case.replace))


def _inputs(cfg, case: Case):
    """The numpy batch, the teacher-forced decode tokens and the page
    tables (each row its own pages after the scratch page 0)."""
    rng = np.random.default_rng(100 + case.seed)
    toks = rng.integers(0, cfg.vocab_size, size=(ROWS, case.tokens)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(ROWS, cfg.num_stub_patches, cfg.d_model)).astype(
            np.float32)
    feed = rng.integers(0, cfg.vocab_size, size=(ROWS, STEPS)).astype(np.int32)
    per_row = -(-(case.tokens + STEPS) // PAGE)
    tables = (1 + np.arange(ROWS * per_row).reshape(ROWS, per_row)).astype(np.int32)
    return batch, feed, tables


def _fill_pools(xp, caches, tables, pool_heads=None):
    """Page pools (L, P, PAGE, KV, hd) holding each row's prefill caches in
    its table's pages; `pool_heads` selects the kv heads they keep."""
    pools = {}
    for name in ("k", "v"):
        c = np.asarray(caches[name])
        if pool_heads is not None:
            c = c[:, :, :, list(pool_heads)]
        layers, rows, t, kvh, hd = c.shape
        pool = np.zeros((layers, 1 + tables.size, PAGE, kvh, hd), c.dtype)
        for r in range(rows):
            pad = np.zeros((layers, tables.shape[1] * PAGE, kvh, hd), c.dtype)
            pad[:, :t] = c[:, r]
            pool[:, tables[r]] = pad.reshape(layers, tables.shape[1], PAGE, kvh, hd)
        pools[name] = xp(pool)
    return pools


@contextlib.contextmanager
def _routes():
    """Every MoE routing decision made inside the block (`moe._top_k`'s
    (n, k) expert indices), appended to the yielded list."""
    from repro_torch.models import moe

    original, seen = moe._top_k, []

    def hooked(probs, k):
        seen.append(original(probs, k))
        return seen[-1]

    moe._top_k = hooked
    try:
        yield seen
    finally:
        moe._top_k = original


# -- the reference: one subprocess with 4 virtual devices ---------------------------


def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.launch.serve import generate as jgenerate
    from repro.models import ShardCtx as JCtx
    from repro.models import get_model as jmodel
    from repro.parallel.sharding import DEFAULT_RULES as JRULES

    outs = {}
    for name, case in CASES.items():
        cfg = dataclasses.replace(_cfg(jconfig, case), use_mesh_kernel=False)
        model = jmodel(cfg)
        params = model.init(jax.random.PRNGKey(case.seed))
        rules = JRULES.replace(seq_attn="model") if case.seq_attn else None
        ctx = JCtx(jmesh(case.mesh, ("data", "model")), rules)
        batch, feed, tables = _inputs(cfg, case)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, caches = jax.jit(lambda p, b, c=ctx, m=model: m.prefill(p, b, c))(params, jb)
        outs[f"{name}/prefill"] = np.asarray(logits)
        if name == "mesh-paper-1x2":  # the unsharded reference, once
            outs["unsharded/prefill"] = np.asarray(jax.jit(model.prefill)(params, jb)[0])
        if case.aux:
            _, aux = jax.jit(lambda p, b, c=ctx, m=model: m.forward(p, b, c))(params, jb)
            outs[f"{name}/aux"] = np.asarray([aux["lb_loss"], aux["router_z"]])
        if case.decode or case.seq_attn:
            outs[f"{name}/cache_k"], outs[f"{name}/cache_v"] = (np.asarray(caches["k"]),
                                                                 np.asarray(caches["v"]))
        if not case.decode:
            continue
        step = jax.jit(lambda p, t, s, pos, c=ctx, m=model: m.decode(p, t, s, pos, c))
        state = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * 2),
                             caches)
        paged = jax.jit(lambda p, t, pl, tb, ps, c=ctx, m=model: m.paged_decode(
            p, t, pl, tb, ps, c, impl="xla_gather"))
        pools = _fill_pools(jnp.asarray, caches, tables)
        for i in range(STEPS):
            lg, state = step(params, jnp.asarray(feed[:, i:i + 1]), state,
                             jnp.int32(case.tokens + i))
            outs[f"{name}/decode{i}"] = np.asarray(lg)
            pos = jnp.full((ROWS,), case.tokens + i, jnp.int32)
            lg, pools = paged(params, jnp.asarray(feed[:, i:i + 1]), pools, jnp.asarray(tables),
                              pos)
            outs[f"{name}/paged{i}"] = np.asarray(lg)
        toks, _ = jgenerate(model, params, jb["tokens"], gen_len=STEPS, ctx=ctx)
        outs[f"{name}/generate"] = np.asarray(toks)
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: 4 gloo ranks ------------------------------------------------------------


def _jax_params(case: Case):
    """The reference's init of `case` as numpy (this rank imports JAX)."""
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
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.models import get_model
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.train.train_step import _local_rows
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    meshes = {shape: make_local_mesh(shape, ("data", "model"))
              for shape in sorted({c.mesh for c in CASES.values()} | {(1, 2), (2, 1)})}
    outs, found = {}, {}
    for name, case in CASES.items():
        if rank >= case.mesh[0] * case.mesh[1]:
            continue
        cfg = dataclasses.replace(_cfg(get_config, case), use_mesh_kernel=True)
        model = get_model(cfg)
        full = interop.params_from_numpy(_jax_params(case), "cpu")
        rules = DEFAULT_RULES.replace(seq_attn="model") if case.seq_attn else None
        ctx = ShardCtx(meshes[case.mesh], rules)
        params = interop.shard_params(full, model, ctx)
        batch, feed, tables = _inputs(cfg, case)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        c = ctx.for_rows(ROWS)
        vocab = full["embed"].shape[0]
        kvh, hd, layers = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers

        def whole_logits(lg):
            return c.gather(lg, ("batch", "seq", "vocab"), (ROWS, None, vocab)).numpy()

        def whole_cache(x):
            return c.gather(x, (None, "kv_batch", "kv_seq", "kv_heads", "head_dim"),
                            (layers, ROWS, None, kvh, hd)).numpy()

        with torch.no_grad(), _routes() as routes:
            logits, caches = model.prefill(params, _local_rows(tb, c), c)
            outs[f"{name}/prefill"] = whole_logits(logits)
            if case.aux:
                _, aux = model.forward(params, _local_rows(tb, c), c)
                outs[f"{name}/aux"] = np.asarray([aux["lb_loss"].item(),
                                                  aux["router_z"].item()])
                found[f"{name}/routes"] = [r.tolist() for r in routes]
                found[f"{name}/layers"] = layers
            if case.decode or case.seq_attn:
                outs[f"{name}/cache_k"] = whole_cache(caches["k"])
                outs[f"{name}/cache_v"] = whole_cache(caches["v"])
            if case.seq_attn:  # the single-process prefill of the same parameters
                single, single_caches = model.prefill(full, tb)
                outs[f"{name}/single_prefill"] = single.numpy()
                outs[f"{name}/single_cache_k"] = single_caches["k"].numpy()
                outs[f"{name}/single_cache_v"] = single_caches["v"].numpy()
                found[f"{name}/heads"] = [head_layout(cfg, c).q.count,
                                          list(c.part("seq_attn", case.tokens))[:3]]
            if case.decode:
                state = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, STEPS))
                         for k, v in caches.items()}
                mine = c.part("batch", ROWS)
                lay = head_layout(cfg, c)
                my_tables = tables[mine.start:mine.start + mine.size]
                my_tables = (my_tables - my_tables.min() + 1).astype(np.int32)
                pools = _fill_pools(torch.as_tensor, caches, my_tables, lay.read)
                for i in range(STEPS):
                    tok = _local_rows({"t": torch.as_tensor(feed[:, i:i + 1])}, c)["t"]
                    lg, state = model.decode(params, tok, state, case.tokens + i, c)
                    outs[f"{name}/decode{i}"] = whole_logits(lg)
                    pos = torch.full((mine.size,), case.tokens + i, dtype=torch.int32)
                    lg, pools = model.paged_decode(params, tok, pools,
                                                   torch.as_tensor(my_tables), pos, c)
                    outs[f"{name}/paged{i}"] = whole_logits(lg)
                toks, _ = tserve.generate(model, params, tb["tokens"], gen_len=STEPS, ctx=ctx)
                outs[f"{name}/generate"] = toks.numpy()
                found[f"{name}/local_wi"] = list(params["blocks"]["mlp"]["wi"].shape)

    # RWKV-6, Zamba2 and Whisper (tests/test_torch_tp_families.py holds them
    # against the reference): the prefill step's next tokens on 1x2 (heads
    # split, each rank its block of the parameters) and on 2x1 (rows split),
    # and whether 2x1's equal the single process's bitwise.
    for arch in UNTP:
        cfg = get_config(arch).reduced()
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(5), "cpu")
        rng = np.random.default_rng(6)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(ROWS, 8)), dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "audio":
            batch["frames"] = torch.as_tensor(
                rng.normal(size=(ROWS, 8 * cfg.dec_ratio, cfg.d_model)), dtype=torch.float32)
        want = tserve.serving_steps(model)[0](params, batch)[0]
        res = {}
        for shape in ((1, 2), (2, 1)):
            if rank >= shape[0] * shape[1]:
                continue
            ctx = ShardCtx(meshes[shape])
            mine = interop.shard_params(params, model, ctx)
            got = tserve.serving_steps(model, ctx)[0](mine, batch)[0]
            res[str(shape)] = got.tolist()
            if shape == (2, 1):
                res["single"] = bool(torch.equal(got, want))
            else:  # under 'model' the loss records a gradient
                leaves = [t.requires_grad_(True) for t in tree_leaves(mine)]
                loss = model.loss(mine, batch, ctx.for_rows(ROWS))[0]
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                res["grad"] = (all(bool(torch.isfinite(g).all()) for g in grads)
                               and all(bool(g.any()) for g in grads[:3]))
        found[arch] = res

    # The continuous-batching server on 1x2 against the single-process one.
    if rank < 2:
        cfg = dataclasses.replace(get_config("mesh-paper").reduced(), use_mesh_kernel=True)
        model = get_model(cfg)
        full = model.init(torch.Generator().manual_seed(7), "cpu")
        scfg = ServeConfig(max_slots=2, page_size=PAGE, num_pages=1 + 2 * 4, max_pages_per_seq=4,
                           queue_capacity=4, warmup_prompt_lens=(12,))
        rng = np.random.default_rng(8)
        reqs = [Request(rid=f"r{i}", prompt=rng.integers(0, cfg.vocab_size, size=(12 + i,)),
                        max_new_tokens=6) for i in range(4)]
        tokens = {}
        for tag, ctx, params in (("single", ShardCtx(), full),
                                 ("mesh", ShardCtx(meshes[(1, 2)]), None)):
            if params is None:
                params = interop.shard_params(full, model, ctx)
            server = ContinuousBatchingServer(model, params, scfg, ctx, device="cpu")
            server.warmup()
            res = server.run([dataclasses.replace(r) for r in reqs])
            tokens[tag] = {rid: r.tokens for rid, r in res.items()}
        found["server"] = tokens
        # Under 2x1 the server's 2 slots split over 'data', one a rank.
        ctx = ShardCtx(meshes[(2, 1)])
        server = ContinuousBatchingServer(model, interop.shard_params(full, model, ctx), scfg,
                                          ctx, device="cpu")
        server.warmup()
        res = server.run([dataclasses.replace(r) for r in reqs])
        found["server_data"] = {rid: r.tokens for rid, r in res.items()}

    # serve --mesh 1x2 on the group's first two ranks (the others take no part).
    argv = ["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    cli = io.StringIO()
    with redirect_stdout(cli):
        tserve.main(argv + ["--mesh", "1x2"])
    found["cli_mesh"] = cli.getvalue()
    if rank == 0:
        single = io.StringIO()
        with redirect_stdout(single):
            tserve.main(argv)
        found["cli_single"] = single.getvalue()

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

    out = tmp_path_factory.mktemp("tp")
    paths = (str(ROOT / "src"), str(ROOT / "tests"))
    env = forced_device_env(WORLD, pythonpath=paths)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_tp as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
    rank_env.pop("XLA_FLAGS", None)
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_tp as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    return types.SimpleNamespace(
        ref=dict(np.load(out / "reference.npz")),
        ranks=[dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
        found=[json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"max |d| {err} > {tol} x max|ref| {scale}"


def _ranks_of(case):
    return range(CASES[case].mesh[0] * CASES[case].mesh[1])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_match_reference_under_its_mesh(runs, case):
    for r in _ranks_of(case):
        _close(runs.ranks[r][f"{case}/prefill"], runs.ref[f"{case}/prefill"])


def test_reference_unsharded_agrees_with_its_mesh(runs):
    """A sharding constraint changes no value of the reference: its
    unsharded prefill equals its 1x2 one within the limit."""
    _close(runs.ref["unsharded/prefill"], runs.ref["mesh-paper-1x2/prefill"])


@pytest.mark.parametrize("case", DECODE_CASES)
def test_prefill_caches_match_reference(runs, case):
    for r in _ranks_of(case):
        for name in ("cache_k", "cache_v"):
            _close(runs.ranks[r][f"{case}/{name}"], runs.ref[f"{case}/{name}"])


@pytest.mark.parametrize("case", SEQ_ATTN_CASES)
def test_context_parallel_prefill_matches_single_process(runs, case):
    """The context-parallel chunked prefill ('seq_attn' on 'model': each
    rank its block of the query rows at a query offset, against the
    gathered keys), where the query heads split over 'model' (1x4) and
    where they replicate (3 heads on 1x2): the ranks' logits and caches
    against the port's single-process prefill and the reference's caches
    (the logits against the reference: the prefill test above)."""
    tokens = CASES[case].tokens
    for r in _ranks_of(case):
        count, rows = runs.found[r][f"{case}/heads"]
        assert rows[2] == CASES[case].mesh[1] and rows[1] == tokens // rows[2], rows
        assert count == (1 if case.endswith("3h-1x2") else CASES[case].mesh[1])
        _close(runs.ranks[r][f"{case}/prefill"], runs.ranks[r][f"{case}/single_prefill"])
        for name in ("cache_k", "cache_v"):
            _close(runs.ranks[r][f"{case}/{name}"], runs.ranks[r][f"{case}/single_{name}"])
            _close(runs.ranks[r][f"{case}/{name}"], runs.ref[f"{case}/{name}"])


@pytest.mark.parametrize("case", DECODE_CASES)
def test_dense_decode_steps_match_reference(runs, case):
    for r in _ranks_of(case):
        for i in range(STEPS):
            _close(runs.ranks[r][f"{case}/decode{i}"], runs.ref[f"{case}/decode{i}"])


@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_steps_match_reference(runs, case):
    """The port's pools hold each rank's read kv heads (at 1x4 one of the 2
    replicated heads); the logits are the reference's paged ones."""
    for r in _ranks_of(case):
        for i in range(STEPS):
            _close(runs.ranks[r][f"{case}/paged{i}"], runs.ref[f"{case}/paged{i}"])


@pytest.mark.parametrize("case", DECODE_CASES)
def test_generate_tokens_equal_reference(runs, case):
    for r in _ranks_of(case):
        np.testing.assert_array_equal(runs.ranks[r][f"{case}/generate"],
                                      runs.ref[f"{case}/generate"])


@pytest.mark.parametrize("case", AUX_CASES)
def test_moe_aux_losses_match_reference(runs, case):
    """Expert parallelism (OLMoE at 16 experts, 4 a rank) and the hidden-dim
    branch (Qwen1.5-MoE, shared experts): aux losses within the limit."""
    for r in _ranks_of(case):
        _close(runs.ranks[r][f"{case}/aux"], runs.ref[f"{case}/aux"])


@pytest.mark.parametrize("case", AUX_CASES)
def test_moe_routing_equal_across_ranks(runs, case):
    """Each rank routes the whole batch itself and fills its part of the
    capacity buffer from its own routing, so every decision (each layer of
    the prefill and the forward) must be equal on every rank."""
    first = runs.found[0][f"{case}/routes"]
    assert len(first) == 2 * runs.found[0][f"{case}/layers"]
    for r in _ranks_of(case)[1:]:
        assert runs.found[r][f"{case}/routes"] == first, f"rank {r} routed otherwise"


def test_fused_gate_up_split_on_each_rank(runs):
    """At 1x2 each rank's mlp wi holds d_ff/2 columns of gate and of up."""
    for r in range(2):
        assert runs.found[r]["mesh-paper-1x2/local_wi"] == [2, 64, 128]
    for r in range(4):
        assert runs.found[r]["mesh-paper-1x4/local_wi"] == [2, 64, 64]


@pytest.mark.parametrize("arch", UNTP)
def test_families_without_tp_refuse_model_axis_and_run_on_data(runs, arch):
    """The families that once refused a 'model' axis: on 1x2 they run
    tensor-parallel and give 2x1's next tokens, which equal the single
    process's bitwise, and their loss records a finite gradient, nonzero
    on the first leaves (training under 'model' is no longer refused;
    test_torch_tp_train.py holds the values)."""
    for r in range(2):
        res = runs.found[r][arch]
        assert res["(1, 2)"] == res["(2, 1)"] and len(res["(1, 2)"]) == ROWS
        assert res["single"] is True
        assert res["grad"] is True


def test_server_under_mesh_serves_the_single_process_tokens(runs):
    """On 1x2 (heads split) and on 2x1 (slots split over 'data')."""
    for r in range(2):
        tokens = runs.found[r]["server"]
        assert len(tokens["mesh"]) == 4 and all(len(t) == 6 for t in tokens["mesh"].values())
        assert tokens["mesh"] == tokens["single"]
        assert runs.found[r]["server_data"] == tokens["single"]


def test_serve_cli_mesh_1x2(runs):
    """`serve --mesh 1x2` on 2 ranks: rank 0 prints its tokens (those of
    the single-process CLI), rank 1 nothing, ranks 2-3 take no part."""
    rows = lambda text: re.findall(r"row 0: (\[.*?\])", text)  # noqa: E731
    mesh, single = runs.found[0]["cli_mesh"], runs.found[0]["cli_single"]
    assert "[serve] mesh: data=1 model=2" in mesh
    assert rows(mesh) and rows(mesh) == rows(single)
    assert all(runs.found[r]["cli_mesh"] == "" for r in range(1, WORLD))


# -- in this process -----------------------------------------------------------------


def test_serve_report_prints_sharding_column(capsys):
    """The port's counterpart of the reference's test of the same name."""
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import report_plan_cache

    mesh = make_local_mesh((1,), ("model",))
    spec = api.GemmSpec(m=8, k=8, n=8, shard=api.ShardSpec.unsharded(mesh))
    api.plan(spec, mesh=mesh, device="cpu")
    info = report_plan_cache(prefix="[t]")
    out = capsys.readouterr().out
    assert "shard=replicated@1" in out and info["size"] >= 1
    assert "shard=-" in out or all(p.get("sharding") for p in info["plans"])


def test_constrain_and_shardctx_c_without_a_mesh_are_the_identity():
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import NO_SHARD, ShardCtx
    from repro_torch.parallel.sharding import constrain

    x = torch.randn(2, 3, 4)
    assert NO_SHARD.c(x, ("batch", "seq", "embed")) is x
    assert NO_SHARD.gather(x, ("batch", "seq", "vocab"), (2, 3, 4)) is x
    assert NO_SHARD.part("heads", 7) == (0, 7, 1, None) and not NO_SHARD.active
    one = make_local_mesh((1, 1), ("data", "model"))  # no process group: a plain layout
    assert constrain(x, ("batch", "seq", "heads"), one) is x
    assert ShardCtx(one).c(x, ("batch", "seq", "heads"), (None, 3, 4)) is x
    with pytest.raises(ValueError, match="not the"):
        constrain(x, ("batch", "seq", "heads"), one, shape=(2, 3, 8))


def test_logical_to_physical_first_wins(pkg_pair):
    """A physical axis appears once a spec and the first logical axis that
    names it keeps it: 'seq_attn' on 'model' takes it from 'heads'."""
    for sharding, mesh in pkg_pair:
        rules = sharding.DEFAULT_RULES.replace(seq_attn="model")
        spec = sharding.logical_to_physical(("batch", "seq_attn", "heads", "head_dim"), mesh,
                                            rules)
        assert tuple(spec) == ("data", "model", None, None)
        spec = sharding.logical_to_physical(("batch", "seq", "heads", "head_dim"), mesh, rules)
        assert tuple(spec) == ("data", None, "model", None)


@pytest.fixture
def pkg_pair():
    pytest.importorskip("jax")
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.parallel import sharding as jsh

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding

    return [(jsh, jmesh((1, 1), ("data", "model"))),
            (sharding, make_local_mesh((1, 1), ("data", "model")))]


def _fake_ctx(model_size, coord, rules=None):
    """A ShardCtx on a plain (data 1, model n) layout placed at `coord`."""
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import MeshLayout

    shape = {"data": 1, "model": model_size}
    lay = MeshLayout(shape, {"data": 0, "model": coord},
                     np.arange(model_size).reshape(1, model_size))
    return ShardCtx(tuple(shape.items()), rules, lay)


@pytest.mark.parametrize("arch", ["mesh-paper", "qwen2-moe-a2.7b", "olmoe-1b-7b"])
def test_shard_params_splits_fused_gate_up_per_rank(arch):
    """Each rank's fused [gate | up] weights are its gate slice beside its
    up slice (a flat split of the last dim would give rank 0 all of gate),
    checked against a tree sliced by hand; the heads split in whole heads."""
    from repro_torch.configs import get_config
    from repro_torch.interop import shard_params
    from repro_torch.models import get_model

    cfg = get_config(arch).reduced()
    if arch == "olmoe-1b-7b":
        cfg = dataclasses.replace(cfg, num_experts=16)
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0), "cpu")
    m, hd = 2, cfg.head_dim_
    for r in range(m):
        got = shard_params(full, model, _fake_ctx(m, r))
        blk = full["blocks"]

        def halves(w, f):
            return torch.cat([w[..., r * f // m:(r + 1) * f // m],
                              w[..., f + r * f // m:f + (r + 1) * f // m]], dim=-1)

        if cfg.is_moe:
            mo = blk["moe"]
            if cfg.num_experts % 16 == 0:  # expert parallelism: whole experts
                e = cfg.num_experts // m
                assert torch.equal(got["blocks"]["moe"]["wi"], mo["wi"][:, r * e:(r + 1) * e])
            else:
                f = cfg.moe_d_ff
                assert torch.equal(got["blocks"]["moe"]["wi"], halves(mo["wi"], f))
                assert torch.equal(got["blocks"]["moe"]["wo"],
                                   mo["wo"][:, :, r * f // m:(r + 1) * f // m])
                fs = cfg.moe_d_ff * cfg.num_shared_experts
                assert torch.equal(got["blocks"]["moe"]["shared_wi"], halves(mo["shared_wi"], fs))
                assert torch.equal(got["blocks"]["moe"]["shared_gate"], mo["shared_gate"])
        else:
            f = cfg.d_ff
            assert torch.equal(got["blocks"]["mlp"]["wi"], halves(blk["mlp"]["wi"], f))
            assert not torch.equal(got["blocks"]["mlp"]["wi"],
                                   blk["mlp"]["wi"][..., r * f:(r + 1) * f])
        h = cfg.num_heads // m
        assert torch.equal(got["blocks"]["attn"]["wq"],
                           blk["attn"]["wq"][..., r * h * hd:(r + 1) * h * hd])
        assert torch.equal(got["blocks"]["attn"]["wo"],
                           blk["attn"]["wo"][:, r * h * hd:(r + 1) * h * hd])
        v = full["embed"].shape[0] // m
        assert torch.equal(got["embed"], full["embed"][r * v:(r + 1) * v])


def test_head_layout_reads_global_kv_heads_where_they_replicate():
    """4 query heads over 2 kv heads on 4 ranks: rank r's one head reads
    global kv head r // 2 from the replicated cache."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import head_layout

    cfg = get_config("mesh-paper").reduced()
    for r in range(4):
        lay = head_layout(cfg, _fake_ctx(4, r))
        assert (lay.q.start, lay.q.size, lay.kv.size, lay.read, lay.rep) == (r, 1, 2, (r // 2,), 1)
    lay = head_layout(cfg, _fake_ctx(2, 1))
    assert (lay.q.size, lay.kv.start, lay.kv.size, lay.read, lay.rep) == (2, 1, 1, (0,), 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0, 8, 24])
def test_chunked_attention_at_a_query_offset(causal, offset):
    """`_sdpa_chunked(q_offset=o)` and the `flash_attention(q_offset=o)`
    wrapper on CPU tensors against `_sdpa` with the same offset: query rows
    [o, o + 8) of a 32-token sequence over keys [0, o + 8)."""
    from repro_torch.kernels.flash_attention import _sdpa_chunked, flash_attention
    from repro_torch.models.attention import _sdpa

    g = torch.Generator().manual_seed(offset)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k, v = torch.randn(2, 2, 32, 2, 16, generator=g).unbind(0)
    keys = offset + 8 if causal else 32
    want = _sdpa(q, k[:, :keys], v[:, :keys], causal=causal, q_offset=offset)
    got = _sdpa_chunked(q, k[:, :keys], v[:, :keys], causal=causal, chunk=8, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-5)
    wrapped = flash_attention(q, k[:, :keys], v[:, :keys], causal=causal, block_q=8, block_k=8,
                              q_offset=offset)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    if causal and offset:
        full = _sdpa(torch.cat([torch.zeros(2, offset, 4, 16), q], 1), k[:, :keys],
                     v[:, :keys], causal=True)[:, offset:]
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, causal=causal, block_q=8, block_k=8, q_offset=-1)
