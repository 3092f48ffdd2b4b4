"""Port parity of the MoE slice: `moe_block` and reduced OLMoE-1B-7B end to end.

The JAX reference initializes the parameters; `params_from_numpy` carries
them into the port, and both packages run the same numpy inputs, on both
backend pairs: the plain one (`torch` against the reference's `xla`) and
the kernel one (`cuda_mesh`, whose grouped GEMM is K5's plain version on the
CPU, against `pallas_mesh` in interpret mode).

  * `moe_block` output and aux (lb_loss, router_z), and the gradients of
    the model's loss, agree within 1e-5 (f32; the k order and reduction
    orders differ), including a T = 512 case whose capacity drops pairs;
  * prefill logits, teacher-forced paged-decode logits and `lm_forward`
    logits with aux and loss agree within atol = rtol = 1e-5;
  * inside the port, paged decode equals dense decode BITWISE on the kernel
    path (within 1e-6 on the plain `torch` backend; the test says why);
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
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "olmoe-1b-7b"
MESH = [False, True]  # cfg.use_mesh_kernel: torch <-> xla, cuda_mesh <-> pallas_mesh


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


@pytest.fixture(scope="module", params=MESH, ids=["torch", "cuda_mesh"])
def models(jx, request):
    """(jax model, jax params, port model, port params), same weights."""
    jc, tc = _cfgs(jx, request.param)
    jm = jx.get_model(jc)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, get_model(tc), tp


def _prompt(i, t=8, vocab=256):
    return np.random.default_rng(200 + i).integers(0, vocab, t).astype(np.int32)


# -- config, params ----------------------------------------------------------


def test_config_matches_reference(jx):
    for reduce in (False, True):
        jc, tc = jx.get_config(ARCH), get_config(ARCH)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                      "vocab_size", "head_dim_", "rope_theta", "norm_eps", "use_mesh_kernel",
                      "param_dtype", "activation_dtype", "family", "num_experts",
                      "num_experts_per_tok", "num_shared_experts", "moe_d_ff",
                      "router_aux_coef", "is_moe", "tie_embeddings", "qkv_bias"):
            assert getattr(tc, field) == getattr(jc, field), field


def test_param_tree_matches_reference_specs(jx, models):
    jm, jp, tm, tp = models
    fresh = tm.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jx.jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    assert shapes(fresh) == jshapes == shapes(tp)
    assert fresh["blocks"]["moe"]["router"].dtype == torch.float32


def test_params_from_numpy_carries_f32_router_bits(jx, models):
    jm, jp, tm, tp = models
    router = np.asarray(jp["blocks"]["moe"]["router"])
    got = tp["blocks"]["moe"]["router"]
    assert router.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), router.view(np.int32))


def test_shared_expert_specs_and_branch():
    """OLMoE with one shared expert gets the reference's three shared leaves
    after the routed ones, in its key order, and `moe_block` runs them
    (`tests/test_torch_qwen2_moe.py` holds their values)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_shared_experts=1)
    specs = tmoe.moe_specs(cfg)
    d, fs = cfg.d_model, cfg.moe_d_ff
    assert list(specs) == ["router", "wi", "wo", "shared_wi", "shared_wo", "shared_gate"]
    assert [specs[k].shape for k in ("shared_wi", "shared_wo", "shared_gate")] == [
        (d, 2 * fs), (fs, d), (d, 1)]
    layer = {k: v[0] for k, v in get_model(cfg).init(
        torch.Generator().manual_seed(0), "cpu")["blocks"]["moe"].items()}
    x = torch.randn(2, 4, d, generator=torch.Generator().manual_seed(3))
    y, _ = tmoe.moe_block(layer, x, cfg)
    y0, _ = tmoe.moe_block(layer, x, dataclasses.replace(cfg, num_shared_experts=0))
    assert y.shape == x.shape and not torch.equal(y, y0)


# -- moe_block ---------------------------------------------------------------


def _moe_inputs(jx, jc, shape, skew):
    """JAX-initialized moe params and an input whose routing leans toward
    expert 0 by `skew` (so that a capacity-bound shape drops pairs)."""
    jp = jx.init_params(jx.jax.random.PRNGKey(0), jx.moe_specs(jc), jc.pdtype)
    pn = jx.jax.tree.map(np.asarray, jp)
    x = np.random.default_rng(1).normal(size=shape + (jc.d_model,)).astype(np.float32)
    x = x + np.float32(skew) * pn["router"][:, 0]
    return jp, pn, x


@pytest.mark.parametrize("mesh", MESH, ids=["torch", "cuda_mesh"])
@pytest.mark.parametrize("shape,skew", [((2, 8), 0.0), ((1, 512), 40.0)],
                         ids=["exact", "capacity"])
def test_moe_block_matches_reference(jx, mesh, shape, skew):
    jc, tc = _cfgs(jx, mesh)
    jp, pn, x = _moe_inputs(jx, jc, shape, skew)
    yj, auxj = jx.moe_block(jp, jx.jnp.asarray(x), jc, jx.NO_SHARD)
    api.clear_plan_cache()
    yt, auxt = tmoe.moe_block(params_from_numpy(pn, "cpu"), torch.from_numpy(x), tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), **TOL)
    n = shape[0] * shape[1]
    cap = tmoe._capacity(n, shape[1], tc.num_experts, tc.num_experts_per_tok, 1.25)
    if skew:
        # The capacity path: cap < n, some expert over it (pairs dropped),
        # and block_m clamped to divide the rows-per-group bound (160 -> 32).
        logits = x.reshape(n, -1) @ pn["router"]
        top = np.argsort(-logits, axis=-1, kind="stable")[:, : tc.num_experts_per_tok]
        assert cap == 160 and np.bincount(top.reshape(-1)).max() > cap
        if mesh:
            blocks = {p["blocks"][0] for p in api.plan_cache_info()["plans"] if p["grouped"]}
            assert blocks == {32}
    else:
        assert cap == n


def test_moe_block_one_grouped_plan_per_expert_shape():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_mesh_kernel=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    api.clear_plan_cache()
    for _ in range(3):
        tmoe.moe_block(layer, x, cfg)
    grouped = [p for p in api.plan_cache_info()["plans"] if p["grouped"]]
    assert len(grouped) == 2  # wi: d -> 2f, wo: f -> d
    assert {p["backend"] for p in grouped} == {"cuda_mesh"}


def test_moe_block_ties_take_the_lower_expert():
    """Equal router probabilities pick the lowest expert indices, as
    jax.lax.top_k does: a zero router makes every expert tie."""
    cfg = get_config(ARCH).reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    layer = {k: v[0].clone() for k, v in params["blocks"]["moe"].items()}
    layer["router"].zero_()
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(2))
    y, _ = tmoe.moe_block(layer, x, cfg)
    # Experts 0 and 1 with gate 1/2 each, run by hand.
    xf = x.reshape(4, -1)
    want = 0
    for e in (0, 1):
        gate, up = torch.chunk(xf @ layer["wi"][e], 2, dim=-1)
        want = want + 0.5 * ((torch.nn.functional.silu(gate) * up) @ layer["wo"][e])
    torch.testing.assert_close(y.reshape(4, -1), want, rtol=1e-5, atol=1e-6)


# -- reduced OLMoE end to end --------------------------------------------------


def test_prefill_logits_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(0), _prompt(1)])
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL)


def test_forward_logits_aux_and_loss_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(2, t=16), _prompt(3, t=16)])
    labels = np.roll(toks, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    lj, auxj = jm.forward(jp, jbatch)
    lt, auxt = tm.forward(tp, tbatch)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for key in ("lb_loss", "router_z"):
        assert float(auxt[key]) > 0
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), **TOL)
    loss_j, met_j = jm.loss(jp, jbatch)
    loss_t, met_t = tm.loss(tp, tbatch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(met_t["accuracy"]), float(met_j["accuracy"]), **TOL)


def test_loss_gradients_match_reference(jx, models):
    """Every parameter's gradient of the model loss (cross-entropy plus the
    router terms), through `_GroupedMM` on the kernel pair, within
    1e-5·max|ref| of jax.grad."""
    from repro_torch.tree import tree_leaves, tree_map

    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(4), _prompt(5)])
    labels = np.roll(toks, -1, axis=1)
    gj = jx.jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})[0])(jp)
    ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, _ = tm.loss(ps, {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)})
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    want = tree_leaves(params_from_numpy(jx.jax.tree.map(np.asarray, gj), "cpu"))
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        tol = 1e-5 * ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=max(tol, 1e-9))
    router_grad = dict(zip([id(x) for x in tree_leaves(ps)], grads))[
        id(ps["blocks"]["moe"]["router"])]
    assert router_grad.abs().max() > 0  # the aux losses reach the router


def _pools(cfg, num_pages, ps):
    shp = (cfg.num_layers, num_pages, ps, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shp), "v": torch.zeros(shp)}


def test_paged_decode_logits_match_reference_teacher_forced(jx, models):
    """Four paged decode steps fed JAX's own greedy tokens, the tracked row
    in a slot batch of three (the others read the scratch page)."""
    jnp = jx.jnp
    jm, jp, tm, tp = models
    cfg = tm.cfg
    t, ps, n_pages, s_slots = 8, 8, 2, 3
    prompt = _prompt(6)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None],
                             "labels": jnp.asarray(prompt)[None]})
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(prompt)[None]})
    pages = np.asarray([3, 5], np.int32)
    layers, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    pool_pages = 1 + s_slots * n_pages
    jpools = {n: jnp.zeros((layers, pool_pages, ps, kv, hd), jnp.float32) for n in "kv"}
    jpools = {n: jpools[n].at[:, pages].set(cj[n][:, 0].reshape(layers, 1, ps, kv, hd))
              for n in "kv"}
    tpools = _pools(cfg, pool_pages, ps)
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


@pytest.mark.parametrize("mesh,atol", [(True, 0.0), (False, 1e-6)], ids=["cuda_mesh", "torch"])
def test_lm_decode_paged_bitwise_matches_lm_decode(mesh, atol):
    """Full-model paged decode == dense-cache decode when the paged capacity
    equals the dense cache capacity; the tracked row sits in a slot batch of
    three on the paged side.  The MoE capacity is n on both sides (1 token vs
    3), and rows_per_group rounds both up to 8, so the grouped GEMMs have one
    shape; the tracked token may land at another row of its expert's block,
    and those products do not depend on the row.

    On the kernel path (`cuda_mesh`, the configuration served on the card)
    the two agree BIT FOR BIT.  On the plain `torch` backend (reduced
    OLMoE's default) they agree within atol 1e-6: the reading is at most
    2.1e-7 on logits up to 0.67, over init seeds 0-4.  The cause is not the
    MoE path but the backend's dense projections: `torch.matmul` with one
    row takes MKL's gemv and with three rows a gemm, which sum in other
    orders.  With those products padded to 16 rows the two paths agree bit
    for bit, so the MoE block (router, stable sorts, scatter, `bmm`,
    combine) is row-independent."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_mesh_kernel=mesh)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    t, ps, n_pages, s_slots = 8, 8, 2, 3
    prompt = torch.as_tensor(_prompt(7))[None]
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        state = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_pages * ps - t))
                 for n, c in caches.items()}
        pools = _pools(cfg, 1 + s_slots * n_pages, ps)
        pages = torch.as_tensor([3, 5])
        for n in "kv":
            pools[n][:, pages] = caches[n][:, 0].reshape(cfg.num_layers, 1, ps,
                                                        cfg.num_kv_heads, cfg.head_dim_)
        bt = torch.zeros((s_slots, n_pages), dtype=torch.int32)
        bt[1] = pages.int()
        # Slots 0 and 2 decode a token too (as the server's empty slots do),
        # so the tracked token shares its experts' blocks with other rows.
        toks = torch.tensor([[17], [0], [42]], dtype=torch.int32)
        for i in range(8):
            lg_d, state = model.decode(params, tok[:, None], state, t + i)
            toks[1, 0] = tok[0]
            positions = torch.zeros((s_slots,), dtype=torch.int32)
            positions[1] = t + i
            lg_p, pools = model.paged_decode(params, toks, pools, bt, positions)
            if atol == 0.0:
                assert torch.equal(lg_p[1, -1], lg_d[0, -1]), f"step {i} diverged"
            else:
                diff = (lg_p[1, -1] - lg_d[0, -1]).abs().max().item()
                assert diff <= atol, f"step {i}: {diff}"
            tok = torch.argmax(lg_d[:, -1], dim=-1).to(torch.int32)


def test_scheduler_trace_matches_jax_server(jx, models):
    jsched = jx.sched
    jm, jp, tm, tp = models
    scfg = dict(max_slots=2, page_size=8, num_pages=7, max_pages_per_seq=3, queue_capacity=4)
    prompts = [_prompt(i) for i in range(3)]
    jreqs = [jsched.Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    want = jsched.ContinuousBatchingServer(jm, jp, jsched.ServeConfig(**scfg)).run(jreqs)
    treqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    server = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu")
    got = server.run(treqs)
    for i in range(3):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens
    # One prefill per request, one decode step per tick that had a ready slot.
    assert server.counters["prefills"] == 3
    assert 0 < server.counters["decode_steps"] <= server.counters["ticks"]


def test_serve_cli_scheduler_on_cpu(capsys):
    api.clear_plan_cache()
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler",
                 "--requests", "2", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                 "--plan-stats"])
    out = capsys.readouterr().out
    assert "req0: ok" in out and "req1: ok" in out
    assert "GEMM plan cache" in out and "grouped" in out
