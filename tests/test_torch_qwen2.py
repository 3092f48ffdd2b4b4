"""Port parity of the Qwen2-7B slice: reduced qwen2-7b end to end, with the
chunked attention path on (attn_chunk = 8) and off (0).

Reduced Qwen2-7B keeps the family's code paths at tiny widths: 2 layers,
d_model 64, 4 heads over 2 KV heads (GQA rep 2), head dim 16, vocab 256,
f32, QKV bias, rope theta 1e6.  The JAX reference initializes the
parameters; the QKV biases, which it initializes to zeros, are replaced by
random values so that they reach the logits; `params_from_numpy` carries
the tree into the port.  Both packages run the same numpy inputs.

  * prefill logits and caches at T = 32 (four chunks of 8), teacher-forced
    paged-decode logits, `lm_forward` logits and loss agree within
    atol = rtol = 1e-5 (f32; reduction orders differ);
  * every gradient of the loss agrees with `jax.grad` within 1e-5 of its
    largest entry — through the chunked recurrence when attn_chunk = 8;
  * the continuous-batching server gives the JAX server's greedy tokens for
    prompts of 16 and 24 tokens, whose prefills take the chunked branch.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen2-7b"
CHUNKS = [8, 0]


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


@pytest.fixture(scope="module", params=CHUNKS, ids=["chunk8", "full"])
def models(jx, request):
    """(jax model, jax params, port model, port params), same weights, with
    random QKV biases."""
    chunk = request.param
    jm = jx.get_model(dataclasses.replace(jx.get_config(ARCH).reduced(), attn_chunk=chunk))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    attn = dict(jp["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jx.jnp.asarray(rng.normal(size=attn[name].shape).astype(np.float32) * 0.5)
    jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    tm = get_model(dataclasses.replace(get_config(ARCH).reduced(), attn_chunk=chunk))
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompt(i, t=32, vocab=256):
    return np.random.default_rng(300 + i).integers(0, vocab, t).astype(np.int32)


class _CountPlain:
    """Counts calls of the flash path's plain version (the CPU side of K6)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        plain = fa.flash_attention_torch

        def counted(*args, **kw):
            self.calls += 1
            return plain(*args, **kw)

        monkeypatch.setattr(fa, "flash_attention_torch", counted)


# -- config, params ----------------------------------------------------------


def test_config_matches_reference(jx):
    for reduce in (False, True):
        jc, tc = jx.get_config(ARCH), get_config(ARCH)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                      "vocab_size", "head_dim_", "rope_theta", "norm_eps", "use_mesh_kernel",
                      "param_dtype", "activation_dtype", "family", "qkv_bias",
                      "tie_embeddings", "is_moe", "attn_chunk", "vocab_pad_multiple"):
            assert getattr(tc, field) == getattr(jc, field), field
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
            full.vocab_size, full.head_dim_) == (28, 3584, 28, 4, 18944, 152064, 128)


def test_param_tree_matches_reference_specs(jx, models):
    jm, jp, tm, tp = models
    fresh = tm.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jx.jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    assert shapes(fresh) == jshapes == shapes(tp)
    assert {"bq", "bk", "bv"} <= set(tp["blocks"]["attn"])
    assert float(fresh["blocks"]["attn"]["bq"].abs().max()) == 0.0  # zeros, as the reference


# -- reduced Qwen2-7B end to end ---------------------------------------------------


def test_prefill_logits_match_reference(jx, models, monkeypatch):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks = np.stack([_prompt(0), _prompt(1)])
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    plain = _CountPlain(monkeypatch)
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert plain.calls == (tm.cfg.num_layers if tm.cfg.attn_chunk else 0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL)


def test_chunk_condition_is_the_reference_one(models, monkeypatch):
    """The flash path runs when attn_chunk > 0, T > chunk and T % chunk == 0;
    T = 8 (one chunk) and T = 12 take full attention."""
    _, _, tm, tp = models
    for t, flash in ((8, False), (12, False), (16, True)):
        plain = _CountPlain(monkeypatch)
        with torch.no_grad():
            tm.forward(tp, {"tokens": torch.as_tensor(_prompt(9, t=t))[None]})
        assert plain.calls == (tm.cfg.num_layers if flash and tm.cfg.attn_chunk else 0), t


def test_paged_decode_logits_match_reference_teacher_forced(jx, models):
    """Four paged decode steps after a 32-token prefill, fed JAX's own greedy
    tokens; the tracked row sits in a slot batch of three (the others read
    the scratch page)."""
    jnp = jx.jnp
    jm, jp, tm, tp = models
    cfg = tm.cfg
    t, ps, n_pages, s_slots = 32, 8, 5, 3
    prompt = _prompt(2)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None],
                             "labels": jnp.asarray(prompt)[None]})
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(prompt)[None]})
    pages = np.asarray([3, 7, 5, 11, 2], np.int32)
    layers, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    pool_pages = 1 + s_slots * n_pages
    used = t // ps
    jpools = {n: jnp.zeros((layers, pool_pages, ps, kv, hd), jnp.float32) for n in "kv"}
    jpools = {n: jpools[n].at[:, pages[:used]].set(cj[n][:, 0].reshape(layers, used, ps, kv, hd))
              for n in "kv"}
    tpools = {n: torch.zeros(layers, pool_pages, ps, kv, hd) for n in "kv"}
    for n in "kv":
        tpools[n][:, torch.as_tensor(pages[:used]).long()] = ct[n][:, 0].reshape(
            layers, used, ps, kv, hd)
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


def _batch(i):
    toks = np.stack([_prompt(10 + i), _prompt(20 + i)])
    return toks, np.roll(toks, -1, axis=1)


def test_forward_logits_and_loss_match_reference(jx, models):
    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks, labels = _batch(0)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    lj, _ = jm.forward(jp, jbatch)
    with torch.no_grad():
        lt, _ = tm.forward(tp, tbatch)
        loss_t, met_t = tm.loss(tp, tbatch)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    loss_j, met_j = jm.loss(jp, jbatch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(met_t["accuracy"]), float(met_j["accuracy"]), **TOL)


def test_loss_gradients_match_reference(jx, models):
    """Every parameter's gradient of the loss (the QKV biases among them)
    within 1e-5·max|ref| of jax.grad."""
    from repro_torch.tree import tree_leaves, tree_map

    jnp = jx.jnp
    jm, jp, tm, tp = models
    toks, labels = _batch(1)
    gj = jx.jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})[0])(jp)
    ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, _ = tm.loss(ps, {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)})
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    want = tree_leaves(params_from_numpy(jx.jax.tree.map(np.asarray, gj), "cpu"))
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        assert ref.abs().max() > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def test_scheduler_trace_matches_jax_server(jx, models, monkeypatch):
    jsched = jx.sched
    jm, jp, tm, tp = models
    scfg = dict(max_slots=2, page_size=8, num_pages=13, max_pages_per_seq=5, queue_capacity=4)
    prompts = [_prompt(i, t=t) for i, t in enumerate((16, 24, 16))]
    jreqs = [jsched.Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    want = jsched.ContinuousBatchingServer(jm, jp, jsched.ServeConfig(**scfg)).run(jreqs)
    treqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
             for i, p in enumerate(prompts)]
    plain = _CountPlain(monkeypatch)
    server = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu")
    got = server.run(treqs)
    for i in range(3):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens
    assert server.counters["prefills"] == 3
    # Every prefill takes the flash path when it is on: one call per layer.
    assert plain.calls == (3 * tm.cfg.num_layers if tm.cfg.attn_chunk else 0)


def test_serve_cli_scheduler_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler",
                 "--requests", "2", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "req0: ok" in out and "req1: ok" in out
