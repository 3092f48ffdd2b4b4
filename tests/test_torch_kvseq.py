"""A sequence-sharded KV cache for dense decode ('kv_seq' on a mesh axis):
the port's decode under the reference's decode rules against the
reference's decode under the same rules.

Spawn pattern of test_torch_tp_train.py: one reference subprocess with 4
virtual CPU devices and one gloo group of 4 port ranks (2 of them used).
Both take each config's parameters from the reference's init and the same
numpy prompts.  Rules: (A) the reference's rule for GQA archs whose kv
heads do not divide 'model', `kv_heads=None, kv_seq="model"`; (B)
`SP_DECODE_RULES` (`kv_seq=("pod", "data")`, the batch replicated), the
long_500k rule.  Each runs on 1x2 and 2x1 (on one of the two its 'kv_seq'
axis has one rank: the cache stays whole there, the other layouts still
apply).  The reference prefills 8 tokens on one device, pads the caches to
16 positions, and decodes 4 tokens with its jitted `model.decode(...,
ctx=ShardCtx(mesh, rules))`.  The ranks prefill under the same rules
without 'kv_seq', pad, keep their block of the positions (rank r holds
[8r, 8r + 8) where the axis has 2 ranks), and decode: the owner of a
position writes it, every rank combines f32 partials (`models.attention`).
Cases: Qwen2-7B reduced (4 query heads over 2 kv heads: under (A) on 1x2
each rank gathers q's heads), Zamba2 (its shared attention's `kv_k` /
`kv_v`) and Whisper (the self-attention cache, and cross-attention over
its seq-sharded encoder output).  Limits: each step's logits and the
final caches, gathered from the ranks' blocks, within 1e-5·max|ref|; each
rank's state shapes equal `Model.decode_state_specs` under the ctx.
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
TOL = 1e-5
PROMPT, MAX, STEPS, ROWS = 8, 16, 4, 2
ARCHS = {"qwen2-7b": 0, "zamba2-1.2b": 1, "whisper-medium": 2}
MESHES = ((1, 2), (2, 1))
CACHES = {"dense": ("k", "v"), "hybrid": ("kv_k", "kv_v"), "audio": ("k", "v")}
CASES = [f"{a}-{r}-{m[0]}x{m[1]}" for a in ARCHS for r in "AB" for m in MESHES]


def _case(name):
    arch, rule, mesh = name.rsplit("-", 2)
    return arch, rule, tuple(int(n) for n in mesh.split("x"))


def _rules(sharding):
    """(A) and (B) of the module docstring, from a sharding module."""
    return {"A": sharding.DEFAULT_RULES.replace(kv_heads=None, kv_seq="model"),
            "B": sharding.SP_DECODE_RULES}


def _inputs(cfg, seed):
    rng = np.random.default_rng(300 + seed)
    toks = rng.integers(0, cfg.vocab_size, size=(ROWS, PROMPT + STEPS)).astype(np.int32)
    frames = rng.normal(size=(ROWS, MAX, cfg.d_model)).astype(np.float32)
    return toks, frames


def _grown(state, names):
    return {k: (np.pad(v, [(0, 0)] * 2 + [(0, MAX - PROMPT)] + [(0, 0)] * 2) if k in names
                else v) for k, v in state.items()}


# -- the reference: one subprocess with 4 virtual devices ---------------------------


def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models import ShardCtx as JCtx
    from repro.models import get_model as jmodel
    from repro.parallel import sharding

    outs = {}
    rules = _rules(sharding)
    for arch, seed in ARCHS.items():
        cfg = dataclasses.replace(jconfig(arch).reduced(), use_mesh_kernel=False)
        model = jmodel(cfg)
        params = model.init(jax.random.PRNGKey(seed))
        toks, frames = _inputs(cfg, seed)
        batch = {"tokens": jnp.asarray(toks[:, :PROMPT]), "labels": jnp.asarray(toks[:, :PROMPT])}
        if cfg.family == "audio":
            batch["frames"] = jnp.asarray(frames)
        _, state = model.prefill(params, batch)
        state = _grown(jax.tree.map(np.asarray, state), CACHES[cfg.family])
        for r in "AB":
            for mesh in MESHES:
                ctx = JCtx(jmesh(mesh, ("data", "model")), rules[r])
                step = jax.jit(lambda p, t, s, pos, ctx=ctx, model=model:
                               model.decode(p, t, s, pos, ctx))
                st = jax.tree.map(jnp.asarray, state)
                name = f"{arch}-{r}-{mesh[0]}x{mesh[1]}"
                for i in range(STEPS):
                    logits, st = step(params, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]), st,
                                      jnp.int32(PROMPT + i))
                    outs[f"{name}/logits{i}"] = np.asarray(logits, np.float32)
                for k in CACHES[cfg.family]:
                    outs[f"{name}/{k}"] = np.asarray(st[k], np.float32)
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: gloo ranks --------------------------------------------------------------


def _rank_main(rank, world, init_file, out_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import torch.distributed as dist

    from repro.configs import get_config as jconfig
    from repro.models import get_model as jmodel
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_model, whisper
    from repro_torch.models.layers import ShardCtx, padded_vocab
    from repro_torch.parallel import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    meshes = {m: make_local_mesh(m, ("data", "model")) for m in MESHES}
    rules = _rules(sharding)
    kv_axes = ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim")
    outs, found = {}, {}
    for arch, seed in ARCHS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), use_mesh_kernel=True)
        model = get_model(cfg)
        full = interop.params_from_numpy(jax.tree.map(
            np.asarray, jmodel(jconfig(arch).reduced()).init(jax.random.PRNGKey(seed))), "cpu")
        toks, frames = (torch.as_tensor(a) for a in _inputs(cfg, seed))
        names = CACHES[cfg.family]
        for r in "AB":
            for mesh in MESHES:
                name = f"{arch}-{r}-{mesh[0]}x{mesh[1]}"
                if rank >= 2:
                    continue
                ctx = ShardCtx(meshes[mesh], rules[r]).for_rows(ROWS)
                rows = ctx.part("batch", ROWS)
                mine = slice(rows.start, rows.start + rows.size)
                params = interop.shard_params(full, model, ctx)
                batch = {"tokens": toks[mine, :PROMPT], "labels": toks[mine, :PROMPT]}
                if cfg.family == "audio":
                    batch["frames"] = frames[mine]
                with torch.no_grad():
                    _, state = model.prefill(params, batch, ShardCtx(
                        meshes[mesh], rules[r].replace(kv_seq=None)).for_rows(ROWS))
                    state = {k: torch.as_tensor(v) for k, v in _grown(
                        {k: v.numpy() for k, v in state.items()}, names).items()}
                    for k in names:  # this rank's block of the positions
                        state[k] = ctx.c(state[k], kv_axes, (None, None, MAX, None, None))
                    if cfg.family == "audio":
                        state["enc_out"] = ctx.c(state["enc_out"], ("kv_batch", "kv_seq",
                                                                    "embed"), (None, MAX, None))
                    if cfg.family == "audio":  # MAX frames and MAX decoder positions
                        specs = whisper.whisper_cache_specs(cfg, rows.size, MAX, MAX, ctx)
                    else:
                        specs = model.decode_state_specs(rows.size, MAX, ctx)
                    found[f"{name}/shapes"] = [
                        [k, list(state[k].shape), list(specs[k][0])] for k in sorted(specs)
                        if k in names + ("enc_out",)]
                    for i in range(STEPS):
                        logits, state = model.decode(
                            params, toks[mine, PROMPT + i:PROMPT + i + 1], state, PROMPT + i, ctx)
                        outs[f"{name}/logits{i}"] = ctx.gather(
                            logits, ("batch", "seq", "vocab"),
                            (ROWS, 1, padded_vocab(cfg))).float().numpy()
                    for k in names:
                        shape = (state[k].shape[0], ROWS, MAX, cfg.num_kv_heads, cfg.head_dim_)
                        outs[f"{name}/{k}"] = ctx.gather(state[k], kv_axes, shape).float().numpy()
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

    out = tmp_path_factory.mktemp("kvseq")
    paths = (str(ROOT / "src"), str(ROOT / "tests"))
    env = forced_device_env(WORLD, pythonpath=paths)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_kvseq as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
    rank_env.pop("XLA_FLAGS", None)
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_kvseq as m;"
                   f" m._rank_main({r}, {WORLD}, {str(init)!r}, {str(out)!r})", rank_env)
              for r in range(WORLD)]
    _finish(procs)
    return types.SimpleNamespace(
        ref=dict(np.load(out / "reference.npz")),
        ranks=[dict(np.load(out / f"rank{r}.npz")) for r in range(2)],
        found=[json.loads((out / f"rank{r}.json").read_text()) for r in range(2)])


def _close(got, want, what):
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * scale, f"{what}: max |d| {err} > {TOL} x max|ref| {scale}"


@pytest.mark.parametrize("case", CASES)
def test_decode_logits_match_reference(runs, case):
    for r in range(2):
        for i in range(STEPS):
            key = f"{case}/logits{i}"
            _close(runs.ranks[r][key], runs.ref[key], f"rank {r} {key}")


@pytest.mark.parametrize("case", CASES)
def test_gathered_caches_match_reference(runs, case):
    arch = _case(case)[0]
    from repro_torch.configs import get_config

    for r in range(2):
        for k in CACHES[get_config(arch).family]:
            _close(runs.ranks[r][f"{case}/{k}"], runs.ref[f"{case}/{k}"], f"rank {r} {k}")


@pytest.mark.parametrize("case", CASES)
def test_state_blocks_are_the_specs(runs, case):
    """Each rank's cache blocks (and Whisper's encoder output) are
    `decode_state_specs` under the ctx: half the positions where the
    'kv_seq' axis has 2 ranks."""
    _, rule, mesh = _case(case)
    seq_ranks = mesh[1] if rule == "A" else mesh[0]
    for r in range(2):
        for k, got, want in runs.found[r][f"{case}/shapes"]:
            assert got == want, (r, k)
            assert got[2 if k != "enc_out" else 1] == MAX // seq_ranks, (r, k)
