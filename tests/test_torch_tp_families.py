"""Tensor-parallel serving of RWKV-6, Zamba2 and Whisper against the
reference under its own mesh, and the continuous-batching server with its
slots split over a 'data' axis (`models.rwkv`, `models.ssm`,
`models.whisper` under a `ShardCtx`, `interop.shard_params`' Mamba2 layout,
`ContinuousBatchingServer` on D x M meshes, `serve --mesh`).

Ranks, as in test_torch_tp.py: one reference subprocess with 4 virtual CPU
devices and one gloo group of 4 port ranks (a `file://` rendezvous in a
temporary directory), started together.  Both take each config's
parameters from the reference's init (`jax.random.PRNGKey(seed)`, through
numpy into the port: `interop.params_from_numpy`, then `shard_params`) and
the same numpy inputs.  The reference runs its jitted steps under
`ShardCtx(make_local_mesh(shape, ("data", "model")))` with
`use_mesh_kernel=False` (its Pallas kernels do not lower under a mesh in
interpret mode); the port keeps `use_mesh_kernel=True` (the kernels' plain
versions on the CPU).  Limits: logits, states and caches within
1e-5·max|ref| (f32; only the order of the sums differs), greedy tokens
equal.

Cases (reduced configs: 2 RWKV layers, 2 Mamba2 layers with the shared
block firing once, Whisper 2 + 2 layers): each family on 1x2 and 1x4;
RWKV-6's chunked WKV, Zamba2's and Whisper's chunked (K6) attention on
1x2; on 1x4 the kv heads (2) replicate, and one Zamba2 case has 2 SSM
heads on 4 ranks, so its Mamba2 blocks replicate (the reference's
`_drop_indivisible`).  Prefill logits and the whole decode state, 4
teacher-forced decode steps on caches grown by 4 (the port's `generate`
grows Zamba2's, a stated divergence, so the reference's greedy tokens come
from the same loop written out), and `generate`'s tokens.  The server:
mesh-paper (paged) and RWKV-6 (stacked state) on 2x1 and 2x2 with 4 slots
and with 3 (which do not divide 'data': every rank runs them all), and
RWKV-6 on 1x2, each against the single-process server's tokens; `serve
--mesh 1x2` of RWKV-6 and `--mesh 2x1 --scheduler` of mesh-paper against
the single-process CLI.  In this process: `shard_params`' split of the
fused [z | x | B | C | dt] projection, conv_w, conv_b, out_norm and
out_proj, and of RWKV-6's heads, against trees sliced by hand.
"""

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
PROMPT, STEPS = 16, 4  # prompt tokens, decode steps (and generated tokens)
ROWS = 2  # batch rows of every case
TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mesh: tuple
    seed: int = 0
    replace: tuple = ()  # config fields set on the reduced config


CASES = {
    "rwkv-1x2": Case("rwkv6-1.6b", (1, 2), 0),
    "rwkv-chunked-1x4": Case("rwkv6-1.6b", (1, 4), 1,
                             (("wkv_chunked", True), ("wkv_chunk", 8))),
    "zamba-chunked-1x2": Case("zamba2-1.2b", (1, 2), 2, (("attn_chunk", 8),)),
    "zamba-1x4": Case("zamba2-1.2b", (1, 4), 3),
    "zamba-ssm2-1x4": Case("zamba2-1.2b", (1, 4), 4, (("ssm_num_heads", 2),)),
    "whisper-chunked-1x2": Case("whisper-medium", (1, 2), 5, (("attn_chunk", 8),)),
    "whisper-1x4": Case("whisper-medium", (1, 4), 6),
}
# The decode state entries generate grows by the new tokens, by family.
GROWN = {"ssm": (), "hybrid": ("kv_k", "kv_v"), "audio": ("k", "v")}
# The server: (arch, mesh, slots).
SERVERS = [(arch, mesh, slots) for arch in ("mesh-paper", "rwkv6-1.6b")
           for mesh in ((2, 1), (2, 2)) for slots in (4, 3)] + [("rwkv6-1.6b", (1, 2), 4)]


def _server_id(s):
    return f"{s[0]}-{s[1][0]}x{s[1][1]}-{s[2]}slots"


def _cfg(get_config, case: Case):
    return dataclasses.replace(get_config(case.arch).reduced(), **dict(case.replace))


def _inputs(cfg, case: Case):
    """The numpy batch and the teacher-forced decode tokens."""
    rng = np.random.default_rng(200 + case.seed)
    toks = rng.integers(0, cfg.vocab_size, size=(ROWS, PROMPT)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(ROWS, PROMPT * cfg.dec_ratio, cfg.d_model)).astype(
            np.float32)
    feed = rng.integers(0, cfg.vocab_size, size=(ROWS, STEPS)).astype(np.int32)
    return batch, feed


def _grow(xp_pad, state, family):
    return {k: (xp_pad(v) if k in GROWN[family] else v) for k, v in state.items()}


# -- the reference: one subprocess with 4 virtual devices ---------------------------


def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jconfig
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models import ShardCtx as JCtx
    from repro.models import get_model as jmodel

    def pad(c):
        return jnp.pad(c, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * (c.ndim - 3))

    outs = {}
    for name, case in CASES.items():
        cfg = dataclasses.replace(_cfg(jconfig, case), use_mesh_kernel=False)
        model = jmodel(cfg)
        params = model.init(jax.random.PRNGKey(case.seed))
        ctx = JCtx(jmesh(case.mesh, ("data", "model")))
        batch, feed = _inputs(cfg, case)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        prefill = jax.jit(lambda p, b, c=ctx, m=model: m.prefill(p, b, c))
        step = jax.jit(lambda p, t, s, pos, c=ctx, m=model: m.decode(p, t, s, pos, c))
        logits, state = prefill(params, jb)
        outs[f"{name}/prefill"] = np.asarray(logits)
        for k, v in state.items():
            outs[f"{name}/state/{k}"] = np.asarray(v)
        st = _grow(pad, state, cfg.family)
        for i in range(STEPS):
            lg, st = step(params, jnp.asarray(feed[:, i:i + 1]), st, jnp.int32(PROMPT + i))
            outs[f"{name}/decode{i}"] = np.asarray(lg)
        # Greedy tokens, the port's `generate` written out.
        st = _grow(pad, state, cfg.family)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        toks = [tok]
        for i in range(STEPS - 1):
            lg, st = step(params, tok[:, None], st, jnp.int32(PROMPT + i))
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
            toks.append(tok)
        outs[f"{name}/generate"] = np.asarray(jnp.stack(toks, 1))
    np.savez(os.path.join(out_dir, "reference.npz"), **outs)


# -- the port: 4 gloo ranks ------------------------------------------------------------


def _jax_params(case: Case):
    """The reference's init of `case` as numpy (this rank imports JAX)."""
    import jax

    from repro.configs import get_config as jconfig
    from repro.models import get_model as jmodel

    params = jmodel(_cfg(jconfig, case)).init(jax.random.PRNGKey(case.seed))
    return jax.tree.map(np.asarray, params)


def _whole_state(cfg, name, x, c):
    """The whole decode-state entry `name` from this rank's block under `c`."""
    if name in ("tm_shift", "cm_shift"):
        return c.gather(x, (None, "batch", None), (None, ROWS, None))
    if name == "wkv":
        return c.gather(x, (None, "batch", "heads", None, None),
                        (None, ROWS, cfg.num_heads, None, None))
    if name == "h":
        return c.gather(x, (None, "batch", "mlp", None, None),
                        (None, ROWS, cfg.ssm_num_heads, None, None))
    if name == "conv":  # [this rank's x channels | B | C]
        d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_size
        hp = c.part("mlp", cfg.ssm_num_heads)
        xs, bc = x[..., :x.shape[-1] - 2 * n], x[..., x.shape[-1] - 2 * n:]
        if hp.count > 1:
            xs = c.gather(xs, (None, "batch", None, "mlp"), (None, ROWS, None, d_in))
        return torch.cat([xs, bc], dim=-1)
    if name == "enc_out":
        return c.gather(x, ("batch", None, None), (ROWS, None, None))
    return c.gather(x, (None, "batch", None, "kv_heads", None),  # k, v, kv_k, kv_v
                    (None, ROWS, None, cfg.num_kv_heads, None))


def _rank_main(rank, world, init_file, out_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.models import get_model
    from repro_torch.models.layers import ShardCtx
    from repro_torch.train.train_step import _local_rows

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    meshes = {shape: make_local_mesh(shape, ("data", "model"))
              for shape in ((1, 2), (1, 4), (2, 1), (2, 2))}
    outs, found = {}, {}

    def pad(c):
        return torch.nn.functional.pad(c, (0, 0, 0, 0, 0, STEPS))

    for name, case in CASES.items():
        if rank >= case.mesh[0] * case.mesh[1]:
            continue
        cfg = dataclasses.replace(_cfg(get_config, case), use_mesh_kernel=True)
        model = get_model(cfg)
        full = interop.params_from_numpy(_jax_params(case), "cpu")
        ctx = ShardCtx(meshes[case.mesh])
        params = interop.shard_params(full, model, ctx)
        batch, feed = _inputs(cfg, case)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        c = ctx.for_rows(ROWS)
        vocab = full["embed"].shape[0]
        with torch.no_grad():
            logits, state = model.prefill(params, _local_rows(tb, c), c)
            outs[f"{name}/prefill"] = c.gather(logits, ("batch", "seq", "vocab"),
                                               (ROWS, None, vocab)).numpy()
            specs = model.decode_state_specs(  # audio: (frames, frames // dec_ratio)
                ROWS, PROMPT * (cfg.dec_ratio if cfg.family == "audio" else 1), c)
            found[f"{name}/specs"] = {k: [list(v.shape), list(specs[k][0])]
                                      for k, v in state.items()}
            for k, v in state.items():
                outs[f"{name}/state/{k}"] = _whole_state(cfg, k, v, c).numpy()
            st = _grow(pad, state, cfg.family)
            for i in range(STEPS):
                tok = _local_rows({"t": torch.as_tensor(feed[:, i:i + 1])}, c)["t"]
                lg, st = model.decode(params, tok, st, PROMPT + i, c)
                outs[f"{name}/decode{i}"] = c.gather(lg, ("batch", "seq", "vocab"),
                                                     (ROWS, None, vocab)).numpy()
            toks, _ = tserve.generate(model, params, tb["tokens"], gen_len=STEPS, ctx=ctx,
                                      frames=tb.get("frames"))
            outs[f"{name}/generate"] = toks.numpy()
            if cfg.family == "hybrid":
                found[f"{name}/in_proj"] = list(params["mamba_seg"]["in_proj"].shape)

    # The continuous-batching server on D x M against the single-process one.
    for arch, shape, slots in SERVERS:
        if rank >= shape[0] * shape[1]:
            continue
        cfg = dataclasses.replace(get_config(arch).reduced(), use_mesh_kernel=True)
        model = get_model(cfg)
        full = model.init(torch.Generator().manual_seed(9), "cpu")
        scfg = ServeConfig(max_slots=slots, page_size=8, num_pages=1 + slots * 4,
                           max_pages_per_seq=4, queue_capacity=8, warmup_prompt_lens=(12,))
        rng = np.random.default_rng(10)
        reqs = [Request(rid=f"r{i}", prompt=rng.integers(0, cfg.vocab_size, size=(12 + i,)),
                        max_new_tokens=6) for i in range(5)]
        tokens = {}
        for tag, ctx in (("single", ShardCtx()), ("mesh", ShardCtx(meshes[shape]))):
            server = ContinuousBatchingServer(model, interop.shard_params(full, model, ctx),
                                              scfg, ctx, device="cpu")
            server.warmup()
            res = server.run([dataclasses.replace(r) for r in reqs])
            tokens[tag] = {rid: r.tokens for rid, r in res.items()}
            tokens[f"{tag}_rows"] = [server._rows.start, server._rows.size]
            if not server._paged:
                tokens[f"{tag}_wkv"] = list(server.state["wkv"].shape)
        found[_server_id((arch, shape, slots))] = tokens

    # The CLI: RWKV-6 on 1x2, mesh-paper's server on 2x1, each beside the
    # single-process CLI (rank 0).
    for tag, argv in (("rwkv", ["--arch", "rwkv6-1.6b", "--mesh", "1x2"]),
                      ("server", ["--arch", "mesh-paper", "--scheduler", "--requests", "3",
                                  "--mesh", "2x1"])):
        base = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen", "4"] + argv[:-2]
        cli = io.StringIO()
        with redirect_stdout(cli):
            tserve.main(base + argv[-2:])
        found[f"cli_{tag}"] = cli.getvalue()
        if rank == 0:
            single = io.StringIO()
            with redirect_stdout(single):
                tserve.main(base)
            found[f"cli_{tag}_single"] = single.getvalue()

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

    out = tmp_path_factory.mktemp("tp_families")
    paths = (str(ROOT / "src"), str(ROOT / "tests"))
    env = forced_device_env(WORLD, pythonpath=paths)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [_run(f"import test_torch_tp_families as m; m._reference_main({str(out)!r})", env)]
    rank_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
    rank_env.pop("XLA_FLAGS", None)
    init = out / "rendezvous"
    procs += [_run(f"import test_torch_tp_families as m;"
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


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_state_matches_reference(runs, case):
    """Every decode-state entry (RWKV's wkv and shifts, Zamba2's h, conv and
    kv caches, Whisper's enc_out and caches), gathered whole, and each
    rank's block of the shape `decode_state_specs(ctx)` gives."""
    names = [k.split("/")[-1] for k in runs.ref if k.startswith(f"{case}/state/")]
    assert names
    for r in _ranks_of(case):
        for name in names:
            _close(runs.ranks[r][f"{case}/state/{name}"], runs.ref[f"{case}/state/{name}"])
        for name, (got, want) in runs.found[r][f"{case}/specs"].items():
            assert got == want, f"rank {r} {name}: block {got}, specs {want}"


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_reference(runs, case):
    for r in _ranks_of(case):
        for i in range(STEPS):
            _close(runs.ranks[r][f"{case}/decode{i}"], runs.ref[f"{case}/decode{i}"])


@pytest.mark.parametrize("case", list(CASES))
def test_generate_tokens_equal_reference(runs, case):
    for r in _ranks_of(case):
        np.testing.assert_array_equal(runs.ranks[r][f"{case}/generate"],
                                      runs.ref[f"{case}/generate"])


def test_mamba_heads_split_or_replicate(runs):
    """in_proj's local width: z, x and dt of the rank's SSM heads beside
    whole B and C (2 x 128/M + 2 x 16 + 4/M at 4 heads); all 290 columns
    where 2 heads do not divide 4."""
    assert runs.found[0]["zamba-chunked-1x2/in_proj"][-1] == 2 * 64 + 2 * 16 + 2
    assert runs.found[0]["zamba-1x4/in_proj"][-1] == 2 * 32 + 2 * 16 + 1
    assert runs.found[3]["zamba-ssm2-1x4/in_proj"][-1] == 2 * 128 + 2 * 16 + 2


@pytest.mark.parametrize("server", SERVERS, ids=_server_id)
def test_server_on_a_mesh_serves_the_single_process_tokens(runs, server):
    """Every request's tokens equal the single-process server's; the slot
    rows split over 'data' where they divide it, and RWKV-6's stacked
    state holds the rank's rows and heads."""
    arch, (d, m), slots = server
    for r in range(d * m):
        got = runs.found[r][_server_id(server)]
        assert len(got["mesh"]) == 5 and all(len(t) == 6 for t in got["mesh"].values())
        assert got["mesh"] == got["single"]
        rows = slots // d if slots % d == 0 else slots
        assert got["mesh_rows"] == [(r // m) * rows if rows < slots else 0, rows]
        if arch.startswith("rwkv"):
            assert got["mesh_wkv"][1:3] == [rows, 4 // m]


@pytest.mark.parametrize("tag", ["rwkv", "server"])
def test_serve_cli_under_a_mesh(runs, tag):
    """`serve --mesh 1x2` of RWKV-6 and `serve --scheduler --mesh 2x1` of
    mesh-paper: rank 0 prints the single-process CLI's tokens, rank 1
    nothing, ranks 2-3 take no part."""
    mesh, single = runs.found[0][f"cli_{tag}"], runs.found[0][f"cli_{tag}_single"]
    pattern = r"row 0: (\[.*?\])" if tag == "rwkv" else r"req\d: ok .*? (\[.*?\])"
    assert re.findall(pattern, mesh) and re.findall(pattern, mesh) == re.findall(pattern, single)
    assert all(runs.found[r][f"cli_{tag}"] == "" for r in range(1, WORLD))


# -- in this process -----------------------------------------------------------------


def _fake_ctx(model_size, coord):
    """A ShardCtx on a plain (data 1, model n) layout placed at `coord`."""
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import MeshLayout

    shape = {"data": 1, "model": model_size}
    lay = MeshLayout(shape, {"data": 0, "model": coord},
                     np.arange(model_size).reshape(1, model_size))
    return ShardCtx(tuple(shape.items()), None, lay)


@pytest.mark.parametrize("m", [2, 4])
def test_shard_params_splits_the_mamba_projection_per_rank(m):
    """Each rank's fused [z | x | B | C | dt] columns are its heads' z, x
    and dt beside B and C whole, conv_w / conv_b its x channels beside B
    and C, out_norm its x channels and out_proj their rows, against a tree
    sliced by hand (a flat split of in_proj would give rank 0 only z)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import shard_params
    from repro_torch.models import get_model

    cfg = get_config("zamba2-1.2b").reduced()
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0), "cpu")
    d_in, n, h = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_size, cfg.ssm_num_heads
    p, hl = d_in // h, h // m
    f, wi = cfg.d_ff, full["shared"]["mlp"]["wi"]
    for r in range(m):
        tree = shard_params(full, model, _fake_ctx(m, r))
        got, seg = tree["mamba_seg"], full["mamba_seg"]
        xs = slice(r * hl * p, (r + 1) * hl * p)
        w = seg["in_proj"]
        z, x, b, c, dt = torch.split(w, [d_in, d_in, n, n, h], dim=-1)
        want = torch.cat([z[..., xs], x[..., xs], b, c, dt[..., r * hl:(r + 1) * hl]], dim=-1)
        assert torch.equal(got["in_proj"], want)
        assert not torch.equal(got["in_proj"], w[..., r * w.shape[-1] // m:
                                                  (r + 1) * w.shape[-1] // m])
        for key in ("conv_w", "conv_b"):
            x, b, c = torch.split(seg[key], [d_in, n, n], dim=-1)
            assert torch.equal(got[key], torch.cat([x[..., xs], b, c], dim=-1))
        assert torch.equal(got["out_norm"], seg["out_norm"][..., xs])
        assert torch.equal(got["out_proj"], seg["out_proj"][..., xs, :])
        for key in ("a_log", "dt_bias", "d_skip"):  # sliced by the model code
            assert torch.equal(got[key], seg[key])
        # the shared block's fused gate/up is split as the dense family's
        assert torch.equal(tree["shared"]["mlp"]["wi"],
                           torch.cat([wi[..., r * f // m:(r + 1) * f // m],
                                      wi[..., f + r * f // m:f + (r + 1) * f // m]], dim=-1))


def test_shard_params_splits_rwkv_in_whole_heads():
    """RWKV-6's wr/wk/wv/wg columns and wo rows split in whole WKV heads
    (the 'heads' unit), cm_wk's columns and cm_wv's rows over 'mlp', and
    cm_wr and the per-channel parameters stay whole; with 2 heads on 4
    ranks the heads replicate while 'mlp' still splits."""
    from repro_torch.configs import get_config
    from repro_torch.interop import shard_params
    from repro_torch.models import get_model

    for heads, m in ((4, 2), (4, 4), (2, 4)):
        cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(), num_heads=heads,
                                  head_dim=64 // heads)
        model = get_model(cfg)
        full = model.init(torch.Generator().manual_seed(1), "cpu")
        blk, hd, f = full["blocks"], cfg.head_dim_, cfg.d_ff
        for r in range(m):
            got = shard_params(full, model, _fake_ctx(m, r))["blocks"]
            hs = (slice(r * heads // m * hd, (r + 1) * heads // m * hd) if heads % m == 0
                  else slice(None))
            for key in ("wr", "wk", "wv", "wg"):
                assert torch.equal(got[key], blk[key][..., hs])
            assert torch.equal(got["wo"], blk["wo"][:, hs])
            assert torch.equal(got["cm_wk"], blk["cm_wk"][..., r * f // m:(r + 1) * f // m])
            assert torch.equal(got["cm_wv"], blk["cm_wv"][:, r * f // m:(r + 1) * f // m])
            for key in ("cm_wr", "w0", "u", "ww2", "gn_g", "gn_b"):
                assert torch.equal(got[key], blk[key])
