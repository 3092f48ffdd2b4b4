"""Port parity of Qwen1.5-MoE-A2.7B: the MoE block with shared experts, and
the reduced model end to end.

The JAX reference initializes the parameters; `params_from_numpy` carries
them into the port, and both packages run the same numpy inputs, on both
backend pairs: the plain one (`torch` against the reference's `xla`) and
the kernel one (`cuda_mesh`, whose GEMMs are K1's and K5's plain versions on
the CPU, against `pallas_mesh` in interpret mode).

  * `moe_block` with its shared branch (fused SwiGLU of width moe_d_ff *
    num_shared_experts, scaled by the f32 sigmoid gate, an N = 1 product):
    output and aux agree within 1e-5, also on a T = 512 case whose capacity
    drops routed pairs;
  * prefill logits, `lm_forward` logits with aux and loss, every
    parameter's loss gradient and teacher-forced paged-decode logits agree
    within atol = rtol = 1e-5 (gradients 1e-5 * max|ref|);
  * a short continuous-batching trace gives the JAX server's greedy tokens.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen2-moe-a2.7b"
MESH = [False, True]  # cfg.use_mesh_kernel: torch <-> xla, cuda_mesh <-> pallas_mesh
IDS = ["torch", "cuda_mesh"]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.launch import scheduler
    from repro.models import ShardCtx
    from repro.models import get_model as get_mdl
    from repro.models.layers import NO_SHARD, init_params
    from repro.models.moe import moe_block, moe_specs

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 sched=scheduler, ShardCtx=ShardCtx, NO_SHARD=NO_SHARD,
                                 init_params=init_params, moe_block=moe_block,
                                 moe_specs=moe_specs)


def _cfgs(jx, mesh):
    jc = dataclasses.replace(jx.get_config(ARCH).reduced(), use_mesh_kernel=mesh)
    tc = dataclasses.replace(get_config(ARCH).reduced(), use_mesh_kernel=mesh)
    return jc, tc


@pytest.fixture(scope="module", params=MESH, ids=IDS)
def models(jx, request):
    """(jax model, jax params, port model, port params), same weights."""
    jc, tc = _cfgs(jx, request.param)
    jm = jx.get_model(jc)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, get_model(tc), tp


def _prompt(i, t=8, vocab=256):
    return np.random.default_rng(300 + i).integers(0, vocab, t).astype(np.int32)


def _batch(pkg, toks, labels):
    return {"tokens": pkg(toks), "labels": pkg(labels)}


def test_config_is_published_qwen15_moe():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.vocab_size, cfg.num_experts, cfg.num_experts_per_tok, cfg.num_shared_experts,
            cfg.moe_d_ff, cfg.d_ff, cfg.qkv_bias, cfg.rope_theta) == (
        24, 2048, 16, 16, 128, 151936, 60, 4, 4, 1408, 5632, True, 1e6)
    red = cfg.reduced()
    assert red.num_shared_experts == 1 and red.remat_policy == "none"


def test_param_tree_matches_reference_specs(jx, models):
    jm, jp, tm, tp = models
    fresh = tm.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jx.jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    assert shapes(fresh) == jshapes == shapes(tp)
    # The reference's spec key order (the init recipe walks keys in order).
    assert list(tmoe.moe_specs(tm.cfg)) == list(jx.moe_specs(jm.cfg))
    assert list(fresh["blocks"]["moe"])[-3:] == ["shared_wi", "shared_wo", "shared_gate"]


# -- moe_block ---------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESH, ids=IDS)
@pytest.mark.parametrize("shape,skew", [((2, 8), 0.0), ((1, 512), 40.0)],
                         ids=["exact", "capacity"])
def test_moe_block_with_shared_experts_matches_reference(jx, mesh, shape, skew):
    jc, tc = _cfgs(jx, mesh)
    jp = jx.init_params(jx.jax.random.PRNGKey(0), jx.moe_specs(jc), jc.pdtype)
    pn = jx.jax.tree.map(np.asarray, jp)
    assert {"shared_wi", "shared_wo", "shared_gate"} <= set(pn)
    x = np.random.default_rng(1).normal(size=shape + (jc.d_model,)).astype(np.float32)
    x = x + np.float32(skew) * pn["router"][:, 0]
    yj, auxj = jx.moe_block(jp, jx.jnp.asarray(x), jc, jx.NO_SHARD)
    api.clear_plan_cache()
    yt, auxt = tmoe.moe_block(params_from_numpy(pn, "cpu"), torch.from_numpy(x), tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), **TOL)
    # The gate ran as an f32 product with N = 1 through the planner.
    gate = [p for p in api.plan_cache_info()["plans"]
            if not p["grouped"] and p["mkn"].endswith(f"x{tc.d_model}x1")]
    assert len(gate) == 1 and gate[0]["dtypes"] == ["float32", "float32"]
    assert gate[0]["backend"] == ("cuda_mesh" if mesh else "torch")


# -- reduced Qwen1.5-MoE end to end ---------------------------------------------


def test_prefill_logits_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(0), _prompt(1)])
    lj, cj = jm.prefill(jp, _batch(jnp.asarray, toks, toks))
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL)


def test_forward_logits_aux_and_loss_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(2, t=16), _prompt(3, t=16)])
    labels = np.roll(toks, -1, axis=1)
    jbatch, tbatch = _batch(jnp.asarray, toks, labels), _batch(torch.as_tensor, toks, labels)
    lj, auxj = jm.forward(jp, jbatch)
    lt, auxt = tm.forward(tp, tbatch)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), **TOL)
    np.testing.assert_allclose(float(tm.loss(tp, tbatch)[0]), float(jm.loss(jp, jbatch)[0]),
                               **TOL)


def test_loss_gradients_match_reference(jx, models):
    """Every parameter's gradient of the model loss, the shared experts' and
    the gate's included, within 1e-5·max|ref| of jax.grad."""
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(4), _prompt(5)])
    labels = np.roll(toks, -1, axis=1)
    gj = jx.jax.grad(lambda p: jm.loss(p, _batch(jnp.asarray, toks, labels))[0])(jp)
    ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, _ = tm.loss(ps, _batch(torch.as_tensor, toks, labels))
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    want = tree_leaves(params_from_numpy(jx.jax.tree.map(np.asarray, gj), "cpu"))
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        tol = 1e-5 * ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=max(tol, 1e-9))
    by_id = dict(zip([id(x) for x in tree_leaves(ps)], grads))
    assert by_id[id(ps["blocks"]["moe"]["shared_gate"])].abs().max() > 0


def test_paged_decode_logits_match_reference_teacher_forced(jx, models):
    """Four paged decode steps fed JAX's own greedy tokens, the tracked row
    in a slot batch of three (the others read the scratch page)."""
    jnp = jx.jnp
    jm, jp, tm, tp = models
    cfg = tm.cfg
    t, ps, n_pages, s_slots = 8, 8, 2, 3
    prompt = _prompt(6)
    lj, cj = jm.prefill(jp, _batch(jnp.asarray, prompt[None], prompt[None]))
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(prompt)[None]})
    pages = np.asarray([3, 5], np.int32)
    layers, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    shp = (layers, 1 + s_slots * n_pages, ps, kv, hd)
    jpools = {n: jnp.zeros(shp, jnp.float32).at[:, pages].set(
        cj[n][:, 0].reshape(layers, 1, ps, kv, hd)) for n in "kv"}
    tpools = {n: torch.zeros(shp) for n in "kv"}
    for n in "kv":
        tpools[n][:, torch.as_tensor(pages).long()] = ct[n][:, 0].reshape(layers, 1, ps, kv, hd)
    bt = np.zeros((s_slots, n_pages), np.int32)
    bt[1] = pages
    tok = int(np.argmax(np.asarray(lj)[0, -1]))
    for i in range(4):
        toks = np.zeros((s_slots, 1), np.int32)
        toks[1, 0] = tok
        pos = np.zeros((s_slots,), np.int32)
        pos[1] = t + i
        lgj, jpools = jm.paged_decode(jp, jnp.asarray(toks), jpools, jnp.asarray(bt),
                                      jnp.asarray(pos), jx.ShardCtx())
        lgt, tpools = tm.paged_decode(tp, torch.as_tensor(toks), tpools, torch.as_tensor(bt),
                                      torch.as_tensor(pos))
        np.testing.assert_allclose(lgt[1, -1].numpy(), np.asarray(lgj)[1, -1], **TOL)
        tok = int(np.argmax(np.asarray(lgj)[1, -1]))


def test_scheduler_trace_matches_jax_server(jx, models):
    jsched = jx.sched
    jm, jp, tm, tp = models
    scfg = dict(max_slots=2, page_size=8, num_pages=7, max_pages_per_seq=3, queue_capacity=4)
    prompts = [_prompt(10 + i) for i in range(3)]
    jreqs = [jsched.Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    want = jsched.ContinuousBatchingServer(jm, jp, jsched.ServeConfig(**scfg)).run(jreqs)
    treqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    got = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu").run(treqs)
    for i in range(3):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens


# -- the server's guarded warmup canary ---------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _serve_once(device, armed):
    """Reduced Qwen1.5-MoE on the kernel path: warmup, then one request,
    with a NaN `kernel.output` poison armed for one fire or not; returns the
    tokens, the planner events recorded and the canary plan."""
    from contextlib import nullcontext

    from repro_torch.resilience import faults, ledger

    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_mesh_kernel=True)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    scfg = ServeConfig(max_slots=2, page_size=8, num_pages=7, max_pages_per_seq=3,
                       queue_capacity=4, warmup_prompt_lens=(8,))
    ledger.clear()
    api.clear_plan_cache()
    server = ContinuousBatchingServer(model, params, scfg, device=device)
    armed_ctx = faults.inject({"kernel.output": faults.FaultSpec(times=1, poison="nan")})
    with armed_ctx if armed else nullcontext():
        server.warmup()
        out = server.run([Request(rid="w0", prompt=_prompt(20), max_new_tokens=6)])
    events = [(e.site, e.fallback) for e in ledger.events()
              if e.site.startswith(("plan.", "guard."))]
    canary = [p for p in api.plan_cache_info()["plans"] if p["mkn"] == "8x8x8"]
    ledger.clear()
    return out["w0"].tokens, events, canary


@pytest.mark.parametrize("armed", [False, True], ids=["healthy", "poisoned"])
def test_warmup_canary_is_guarded(armed):
    """The reference's canary: `zero_and_record`, run through `dispatch`
    and directly.  An armed NaN poison lands in it (one `guard.nonfinite`
    event, scrubbed) and the served tokens equal a healthy run's."""
    tokens, events, canary = _serve_once("cpu", armed)
    healthy, none, _ = _serve_once("cpu", False)
    assert none == []
    assert events == ([("guard.nonfinite", "zero")] if armed else [])
    assert tokens == healthy
    assert len(canary) == 1 and canary[0]["health"]["guard_nonfinite"] == "zero_and_record"


def test_guarded_canary_records_no_event_on_card(cuda):
    from repro_torch.kernels.mesh_matmul import mesh_matmul

    before = mesh_matmul.launches_by_config.get("simt_decode", 0)
    tokens, events, canary = _serve_once(cuda, False)
    assert events == [] and len(tokens) == 6
    assert canary[0]["health"]["guard_nonfinite"] == "zero_and_record"
    # The 8x8 canary on 8-wide blocks: two launches, dispatch and direct.
    assert mesh_matmul.launches_by_config.get("simt_decode", 0) - before == 2


@pytest.mark.parametrize("m", [4, 128, 4096])
def test_shared_gate_takes_the_f32_tile(m):
    """K1's wrapper pads the gate's N = 1 to one 16-byte chunk (4 f32
    columns), so the product takes the f32 tile, not a first SIMT tile."""
    from repro_torch.kernels.mesh_matmul import kernel_n, tile_config

    f32 = torch.float32
    assert tile_config(m, 1, 2048, 128, 128, 128, f32) in ("simt_decode", "simt64")
    assert kernel_n(1, 128, f32) == 4
    assert tile_config(m, kernel_n(1, 128, f32), 2048, 128, 128, 128, f32) == "f32_128"
    assert kernel_n(3, 128, torch.bfloat16) == 8 and kernel_n(8, 128, torch.bfloat16) == 8
    assert kernel_n(1, 128, f32, scramble_out=True) == 1 and kernel_n(1, 2, f32) == 1
