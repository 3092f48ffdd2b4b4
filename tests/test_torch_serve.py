"""Port parity of the serving slice: reduced mesh-paper end to end.

The JAX reference initializes the parameters; `params_from_numpy` carries
them into the port, and both packages serve the same numpy prompts.

  * prefill logits and teacher-forced paged-decode logits agree within
    atol = rtol = 1e-5 (f32; the GEMM k order and reduction orders differ);
  * inside the port, paged decode equals dense decode BITWISE;
  * a short continuous-batching trace gives the JAX server's greedy tokens.

The scheduler's own contract (allocator, shed / deadline / preempt, fault
sites) is tested on the port alone, against its own `generate()`, as
tests/test_scheduler.py does for the reference.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import (  # noqa: E402
    ContinuousBatchingServer,
    PageAllocator,
    PagesExhausted,
    Request,
    ServeConfig,
)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.resilience import faults, ledger  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


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

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 sched=scheduler, ShardCtx=ShardCtx)


@pytest.fixture(scope="module")
def models(jx):
    """(jax model, jax params, port model, port params), same weights."""
    jm = jx.get_model(jx.get_config("mesh-paper").reduced())
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = get_model(get_config("mesh-paper").reduced())
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def dense():
    """Reduced mesh-paper in the port alone, random weights from a seed."""
    model = get_model(get_config("mesh-paper").reduced())
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def _prompt(i, t=8, vocab=256):
    return np.random.default_rng(100 + i).integers(0, vocab, t).astype(np.int32)


def _legacy_tokens(model, params, prompt, gen):
    out, _ = generate(model, params, torch.as_tensor(prompt)[None], gen_len=gen)
    return out[0].tolist()


# -- parity with the JAX package ---------------------------------------------


def test_config_matches_reference(jx):
    for reduce in (False, True):
        jc, tc = jx.get_config("mesh-paper"), get_config("mesh-paper")
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                      "vocab_size", "head_dim_", "rope_theta", "norm_eps",
                      "use_mesh_kernel", "param_dtype", "activation_dtype", "family"):
            assert getattr(tc, field) == getattr(jc, field), field


def test_params_from_numpy_carries_bf16_bits(jx):
    jnp = jx.jnp
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(4, 6), jnp.bfloat16))
    t = params_from_numpy({"a": {"b": x}}, "cpu")["a"]["b"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), x.view(np.int16))


def test_param_tree_matches_reference_specs(jx, models):
    jm, jp, tm, tp = models
    gen = torch.Generator().manual_seed(0)
    fresh = tm.init(gen, "cpu")
    jshapes = jx.jax.tree.map(lambda x: tuple(x.shape), jp)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    assert shapes(fresh) == jshapes == shapes(tp)


def test_prefill_logits_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(0), _prompt(1)])
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL)


def _pools(model_cfg, num_pages, ps, make):
    kv, hd = model_cfg.num_kv_heads, model_cfg.head_dim_
    shp = (model_cfg.num_layers, num_pages, ps, kv, hd)
    return {"k": make(shp), "v": make(shp)}


def test_paged_decode_logits_match_reference_teacher_forced(jx, models):
    """Four paged decode steps fed JAX's own greedy tokens."""
    jnp = jx.jnp
    jm, jp, tm, tp = models
    cfg = tm.cfg
    t, ps, n_pages, s_slots = 8, 8, 2, 3
    prompt = _prompt(2)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None],
                             "labels": jnp.asarray(prompt)[None]})
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(prompt)[None]})
    pages = np.asarray([3, 5], np.int32)
    pool_pages = 1 + s_slots * n_pages
    kv, hd, layers = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    jpools = {n: jnp.zeros((layers, pool_pages, ps, kv, hd), jnp.float32) for n in "kv"}
    jpools = {n: jpools[n].at[:, pages].set(cj[n][:, 0].reshape(layers, 1, ps, kv, hd))
              for n in "kv"}
    tpools = {n: torch.zeros(layers, pool_pages, ps, kv, hd) for n in "kv"}
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


def test_lm_decode_paged_bitwise_matches_lm_decode(dense):
    """Full-model paged decode == dense-cache decode, bit for bit, when the
    paged capacity equals the dense cache capacity; the tracked row sits in
    a wider slot batch on the paged side."""
    model, params = dense
    cfg = model.cfg
    t, ps, n_pages, s_slots = 8, 8, 2, 3
    prompt = torch.as_tensor(_prompt(3))[None]
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        state = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_pages * ps - t))
                 for n, c in caches.items()}
        pools = _pools(cfg, 1 + s_slots * n_pages, ps, torch.zeros)
        pages = torch.as_tensor([3, 5])
        for n in "kv":
            pools[n][:, pages] = caches[n][:, 0].reshape(cfg.num_layers, 1, ps,
                                                        cfg.num_kv_heads, cfg.head_dim_)
        bt = torch.zeros((s_slots, n_pages), dtype=torch.int32)
        bt[1] = pages.int()
        tok_p = tok
        for i in range(8):
            lg_d, state = model.decode(params, tok[:, None], state, t + i)
            toks = torch.zeros((s_slots, 1), dtype=torch.int32)
            toks[1, 0] = tok_p[0]
            positions = torch.zeros((s_slots,), dtype=torch.int32)
            positions[1] = t + i
            lg_p, pools = model.paged_decode(params, toks, pools, bt, positions)
            assert torch.equal(lg_p[1, -1], lg_d[0, -1]), f"step {i} diverged"
            tok = torch.argmax(lg_d[:, -1], dim=-1).to(torch.int32)
            tok_p = torch.argmax(lg_p[1:2, -1], dim=-1).to(torch.int32)


def test_paged_decode_rejects_multi_token(dense):
    model, params = dense
    pools = _pools(model.cfg, 4, 8, torch.zeros)
    with pytest.raises(ValueError, match="single-token"):
        model.paged_decode(params, torch.zeros((2, 3), dtype=torch.int32), pools,
                           torch.zeros((2, 2), dtype=torch.int32),
                           torch.zeros((2,), dtype=torch.int32))


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
    got = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu").run(treqs)
    for i in range(3):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens


# -- the port's scheduler on its own -----------------------------------------


def test_allocator_reserves_scratch_page():
    alloc = PageAllocator(4)
    assert sorted(alloc.alloc(3, reason="admit")) == [1, 2, 3]
    assert alloc.free_count == 0


def test_allocator_exhaustion_and_reuse():
    alloc = PageAllocator(4)
    pages = alloc.alloc(2, reason="admit")
    with pytest.raises(PagesExhausted):
        alloc.alloc(2, reason="grow")
    alloc.free(pages)
    assert alloc.free_count == 3


def test_allocator_double_free_rejected():
    alloc = PageAllocator(4)
    pages = alloc.alloc(1, reason="admit")
    alloc.free(pages)
    with pytest.raises(ValueError, match="double free"):
        alloc.free(pages)
    with pytest.raises(ValueError, match="out of range"):
        alloc.free([0])


def test_serve_config_validation():
    with pytest.raises(ValueError, match="max_slots"):
        ServeConfig(max_slots=0)
    with pytest.raises(ValueError, match="num_pages"):
        ServeConfig(num_pages=1)


def test_staggered_requests_equal_legacy(dense):
    """Five requests one tick apart through two slots: admission order, slot
    reuse and page placement never change any request's tokens."""
    model, params = dense
    prompts = [_prompt(i) for i in range(5)]
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=2, page_size=8, num_pages=9, max_pages_per_seq=2,
                    queue_capacity=8, warmup_prompt_lens=(8,)),
        device="cpu",
    )
    server.warmup()
    results = server.run([Request(rid=f"r{i}", prompt=p, max_new_tokens=8, arrival=i)
                          for i, p in enumerate(prompts)])
    assert server.counters["served"] == 5
    for i, p in enumerate(prompts):
        assert results[f"r{i}"].status == "ok"
        assert results[f"r{i}"].tokens == _legacy_tokens(model, params, p, 8)


def test_queue_overflow_sheds_deterministically(dense):
    model, params = dense
    ledger.clear()
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=1, page_size=8, num_pages=5, max_pages_per_seq=2,
                    queue_capacity=2),
        device="cpu",
    )
    for i in range(5):
        server.submit(Request(rid=f"q{i}", prompt=_prompt(i), max_new_tokens=4))
    shed = [e for e in ledger.events("serve.shed") if e.cause == "queue_full"]
    assert [dict(e.detail)["rid"] for e in shed] == ["'q2'", "'q3'", "'q4'"]
    server.drain()
    assert server.results["q0"].status == server.results["q1"].status == "ok"
    assert server.counters["shed"] == 3 and server.counters["served"] == 2


def test_never_fits_request_shed_up_front(dense):
    model, params = dense
    ledger.clear()
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=1, page_size=8, num_pages=5, max_pages_per_seq=2,
                    queue_capacity=4),
        device="cpu",
    )
    server.submit(Request(rid="big", prompt=_prompt(0), max_new_tokens=64))
    assert server.results["big"].status == "shed"
    assert "too_long" in server.results["big"].reason
    assert server.pending == 0 and ledger.count("serve.shed") == 1


def test_deadline_evicts_running_sequence(dense):
    model, params = dense
    ledger.clear()
    scfg = ServeConfig(max_slots=1, page_size=8, num_pages=9, max_pages_per_seq=4,
                       queue_capacity=4)
    server = ContinuousBatchingServer(model, params, scfg, device="cpu")
    server.submit(Request(rid="slow", prompt=_prompt(0), max_new_tokens=24, deadline=5))
    server.drain()
    res = server.results["slow"]
    assert res.status == "timeout" and 0 < len(res.tokens) < 24
    (ev,) = ledger.events("serve.timeout")
    assert dict(ev.detail)["rid"] == "'slow'" and ev.fallback == "evict"
    assert server.alloc.free_count == scfg.num_pages - 1


def test_deadline_expires_queued_request_and_zero_deadline(dense):
    model, params = dense
    scfg = ServeConfig(max_slots=1, page_size=8, num_pages=9, max_pages_per_seq=2,
                       queue_capacity=4)
    server = ContinuousBatchingServer(model, params, scfg, device="cpu")
    server.submit(Request(rid="hog", prompt=_prompt(0), max_new_tokens=8))
    server.submit(Request(rid="late", prompt=_prompt(1), max_new_tokens=4, deadline=3))
    server.submit(Request(rid="now", prompt=_prompt(2), max_new_tokens=4, deadline=0))
    server.drain()
    assert server.results["hog"].status == "ok"
    assert server.results["late"].status == "timeout"
    assert server.results["late"].reason == "deadline_queued"
    assert server.results["now"].status == "timeout" and server.results["now"].tokens == []


@pytest.mark.parametrize("prio,victim,survivors", [((0, 1), "p0", ("p1",)),
                                                   ((1, 0), "p1", ("p0",))])
def test_preemption_evicts_lowest_priority(dense, prio, victim, survivors):
    """Two sequences growing into a pool that holds only one: the
    lower-priority one is preempted (itself, when it is the requester), the
    survivor finishes equal to legacy, and all pages come back."""
    model, params = dense
    ledger.clear()
    scfg = ServeConfig(max_slots=2, page_size=8, num_pages=6, max_pages_per_seq=3,
                       queue_capacity=4)
    server = ContinuousBatchingServer(model, params, scfg, device="cpu")
    results = server.run([Request(rid=f"p{i}", prompt=_prompt(i), max_new_tokens=16,
                                  priority=prio[i]) for i in range(2)])
    assert results[victim].status == "preempted" and 0 < len(results[victim].tokens) < 16
    for rid in survivors:
        assert results[rid].status == "ok"
        assert results[rid].tokens == _legacy_tokens(model, params, _prompt(int(rid[1])), 16)
    (ev,) = ledger.events("serve.preempt")
    assert dict(ev.detail)["rid"] == f"'{victim}'" and ev.cause == "pages_exhausted"
    assert server.alloc.free_count == scfg.num_pages - 1


def test_preemption_victim_later_in_snapshot_does_not_leak_pages(dense):
    model, params = dense
    ledger.clear()
    scfg = ServeConfig(max_slots=3, page_size=8, num_pages=7, max_pages_per_seq=3,
                       queue_capacity=4)
    server = ContinuousBatchingServer(model, params, scfg, device="cpu")
    results = server.run([Request(rid=f"u{i}", prompt=_prompt(i), max_new_tokens=16,
                                  priority=0 if i == 2 else 1) for i in range(3)])
    assert results["u2"].status == "preempted"
    for i in (0, 1):
        assert results[f"u{i}"].status == "ok"
    assert server.counters["preempted"] == 1
    assert server.alloc.free_count == scfg.num_pages - 1


def test_serve_admit_fault_sheds_exactly_one_request(dense):
    model, params = dense
    ledger.clear()
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=2, page_size=8, num_pages=9, max_pages_per_seq=2,
                    queue_capacity=8),
        device="cpu",
    )
    with faults.inject({"serve.admit": faults.FaultSpec(times=1)}):
        results = server.run([Request(rid=f"a{i}", prompt=_prompt(i), max_new_tokens=4)
                              for i in range(3)])
    assert results["a0"].status == "shed"
    assert results["a1"].status == "ok" and results["a2"].status == "ok"
    assert results["a1"].tokens == _legacy_tokens(model, params, _prompt(1), 4)
    shed = ledger.events("serve.shed")
    assert len(shed) == 1 and "injected fault" in shed[0].cause


def test_serve_step_fault_skips_tick_not_server(dense):
    model, params = dense
    ledger.clear()
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=1, page_size=8, num_pages=5, max_pages_per_seq=2,
                    queue_capacity=4),
        device="cpu",
    )
    with faults.inject({"serve.step": faults.FaultSpec(times=1)}):
        results = server.run([Request(rid="s0", prompt=_prompt(0), max_new_tokens=4)])
    assert results["s0"].status == "ok"
    assert results["s0"].tokens == _legacy_tokens(model, params, _prompt(0), 4)
    assert server.counters["skipped_ticks"] == 1
    (ev,) = ledger.events("serve.step")
    assert ev.fallback == "skip_tick"


@pytest.mark.parametrize("reason,fallback,max_pages,gen",
                         [("admit", "defer_admission", 2, 4), ("grow", "stall", 3, 10)])
def test_page_alloc_fault_defers_or_stalls(dense, reason, fallback, max_pages, gen):
    model, params = dense
    ledger.clear()
    server = ContinuousBatchingServer(
        model, params,
        ServeConfig(max_slots=1, page_size=8, num_pages=5, max_pages_per_seq=max_pages,
                    queue_capacity=4),
        device="cpu",
    )
    with faults.inject({"kv.page_alloc": faults.FaultSpec(times=1, match={"reason": reason})}):
        results = server.run([Request(rid="d0", prompt=_prompt(0), max_new_tokens=gen)])
    assert results["d0"].status == "ok"
    assert results["d0"].tokens == _legacy_tokens(model, params, _prompt(0), gen)
    (ev,) = ledger.events("kv.page_alloc")
    assert ev.fallback == fallback
    assert server.counters["preempted"] == 0


def test_duplicate_rid_rejected_and_context_manager_drains(dense):
    model, params = dense
    scfg = ServeConfig(max_slots=1, page_size=8, num_pages=5, max_pages_per_seq=2,
                       queue_capacity=4)
    with ContinuousBatchingServer(model, params, scfg, device="cpu") as server:
        server.submit(Request(rid="cm", prompt=_prompt(0), max_new_tokens=4))
        with pytest.raises(ValueError, match="duplicate"):
            server.submit(Request(rid="cm", prompt=_prompt(1), max_new_tokens=4))
    assert server.results["cm"].status == "ok"


def test_server_rejects_params_on_another_device(dense):
    model, params = dense
    with pytest.raises(ValueError, match="parameters live on"):
        ContinuousBatchingServer(model, params, ServeConfig(), device="meta")


def test_generate_degenerate_timing_reports_zero(dense):
    model, params = dense
    _, rate = generate(model, params, torch.as_tensor(_prompt(0))[None], gen_len=1)
    assert rate == 0.0


def test_serve_requests_isolates_a_failing_request(dense):
    model, params = dense
    ledger.clear()
    ok = torch.as_tensor(_prompt(0))[None]
    with faults.inject({"serve.request": faults.FaultSpec(times=1)}):
        results = tserve.serve_requests(model, params, [ok, ok], gen_len=3)
    assert results[0] is None and results[1] is not None
    assert ledger.count("serve.request") == 1


@pytest.mark.parametrize("extra", [[], ["--scheduler", "--requests", "2"]])
def test_serve_cli_on_cpu(capsys, extra):
    api.clear_plan_cache()
    tserve.main(["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4", "--plan-stats", *extra])
    out = capsys.readouterr().out
    assert "GEMM plan cache" in out and "cuda_mesh" in out
    if extra:
        assert "req0: ok" in out and "req1: ok" in out
    else:
        assert "req 0: decode steps/s" in out
