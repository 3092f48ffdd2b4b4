"""Port parity of RWKV-6 (`repro_torch.models.rwkv`, the ssm family).

The same seeded numpy inputs and JAX-initialised weights (carried over by
`params_from_numpy`) go through both packages; f32 throughout, held within
atol = rtol = 1e-5 (reduction orders differ), except where the chunked WKV's
own rounding is larger (`_chunked_tol`: near-0 decays):

  * `_wkv_scan` and `_wkv_chunked` against the reference's at T = 16, 32
    and 256 (the reference's scan runs two-level at 256), with decays near
    0, near 1 and spread between;
  * reduced RWKV-6 untuned (the scan) and `tuned()` (the chunked WKV on
    16-token prompts): forward, prefill logits and states, and stepwise
    decode logits and states;
  * the continuous-batching server on its stacked-state path: the
    reference server's greedy tokens, and the port's own `generate`;
  * `launch/train.py` trains the family (it refused until its training
    was ported).
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.launch import scheduler
    from repro.models import get_model as get_mdl
    from repro.models import rwkv

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 sched=scheduler, rwkv=rwkv)


# -- the WKV recurrence ---------------------------------------------------------

# Near 0 stays above f32's smallest normal (1.2e-38): the reference's clamp
# `maximum(w, 1e-38)` is itself subnormal, and XLA's CPU code flushes it to
# 0, so its chunked form reads log(0) and returns NaN where w underflows.
# The port keeps the clamp finite; `test_wkv_chunked_survives_underflowed_decay`
# holds it against its own scan there.
DECAYS = {
    "near0": lambda rng, shape: np.exp(-np.exp(rng.normal(2.0, 0.4, shape))),  # ~e^-7
    "near1": lambda rng, shape: np.exp(-np.exp(rng.normal(-8.0, 0.5, shape))),  # ~1-3e-4
    "spread": lambda rng, shape: rng.uniform(0.01, 0.999, shape),
}


def _chunked_tol(w, chunk=16):
    """The chunked form's limit.  Its exponents are differences of
    cumulative log-decays as large as chunk * max|log w|, which f32 holds to
    2^-24 of that; exp turns the absolute error into a relative one.  So the
    limit is 2 chunk max|log w| 2^-24 where that exceeds 1e-5 (near-0
    decays: |log w| up to ~40, a limit of ~8e-5), else 1e-5."""
    tol = max(1e-5, 2 * chunk * float(np.abs(np.log(np.maximum(w, 1e-38))).max()) * 2**-24)
    return dict(atol=tol, rtol=tol)


def _wkv_inputs(t, decay, b=2, h=3, k=8, seed=0):
    rng = np.random.default_rng(seed + t)
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32) * 0.5 for _ in range(3))
    w = DECAYS[decay](rng, (b, t, h, k)).astype(np.float32)
    u = rng.normal(size=(h, k)).astype(np.float32) * 0.5
    s0 = rng.normal(size=(b, h, k, k)).astype(np.float32) * 0.1
    return r, kk, v, w, u, s0


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("t", [16, 32, 256])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_wkv_matches_reference(jx, form, t, decay):
    args = _wkv_inputs(t, decay)
    ref = getattr(jx.rwkv, f"_wkv_{form}")
    got = getattr(trwkv, f"_wkv_{form}")
    o_j, s_j = ref(*(jx.jnp.asarray(a) for a in args))
    o_t, s_t = got(*(torch.as_tensor(a) for a in args))
    tol = _chunked_tol(args[3]) if form == "chunked" else TOL
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **tol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **tol)
    assert np.isfinite(o_t.numpy()).all() and np.isfinite(s_t.numpy()).all()


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_wkv_chunked_equals_scan(decay):
    inputs = _wkv_inputs(64, decay, seed=5)
    args = [torch.as_tensor(a) for a in inputs]
    o_s, s_s = trwkv._wkv_scan(*args)
    o_c, s_c = trwkv._wkv_chunked(*args, chunk=16)
    torch.testing.assert_close(o_c, o_s, **_chunked_tol(inputs[3]))
    torch.testing.assert_close(s_c, s_s, **_chunked_tol(inputs[3]))


def test_wkv_chunked_survives_underflowed_decay():
    """Decays of exactly 0 and subnormal ones: the clamp keeps every log
    finite, and the chunked form equals the scan."""
    r, k, v, w, u, s0 = _wkv_inputs(32, "spread", seed=9)
    w = w.copy()
    w[:, ::3] = 0.0
    w[:, 1::5] = 1e-40
    args = [torch.as_tensor(a) for a in (r, k, v, w, u, s0)]
    o_s, s_s = trwkv._wkv_scan(*args)
    o_c, s_c = trwkv._wkv_chunked(*args, chunk=16)
    assert torch.isfinite(o_c).all() and torch.isfinite(s_c).all()
    torch.testing.assert_close(o_c, o_s, **_chunked_tol(w))
    torch.testing.assert_close(s_c, s_s, **_chunked_tol(w))


def test_wkv_chunked_rejects_ragged_length():
    with pytest.raises(ValueError, match="not divisible"):
        trwkv._wkv_chunked(*(torch.as_tensor(a) for a in _wkv_inputs(20, "spread")))


# -- reduced RWKV-6 end to end ----------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["scan", "tuned"])
def models(jx, request):
    """(jax model, jax params, port model, port params) on the same weights."""
    def cfg(c):
        return c.tuned().reduced() if request.param else c.reduced()

    jm = jx.get_model(cfg(jx.get_config(ARCH)))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = get_model(cfg(get_config(ARCH)))
    assert tm.cfg.wkv_chunked == request.param and tm.cfg.attn_chunk == 0
    return jm, jp, tm, params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, b=2, t=16):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _close_states(got, want):
    assert set(got) == set(want) == {"wkv", "tm_shift", "cm_shift"}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name,
                                   **TOL)


def test_forward_and_prefill_match_reference(jx, models):
    jm, jp, tm, tp = models
    toks = _tokens(1)
    lj, _ = jm.forward(jp, {"tokens": jx.jnp.asarray(toks)})
    lt, aux = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    assert aux == {}
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    lj, sj = jm.prefill(jp, {"tokens": jx.jnp.asarray(toks)})
    lt, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _close_states(st, sj)
    # The state specs are the reference's, as (shape, dtype).
    specs = tm.decode_state_specs(2, 99)
    for name, s in jm.decode_state_specs(2, 99).items():
        assert specs[name][0] == s.shape and str(specs[name][1]) == f"torch.{s.dtype}"


def test_stepwise_decode_matches_reference(jx, models):
    jm, jp, tm, tp = models
    toks = _tokens(2, t=12)
    _, sj = jm.prefill(jp, {"tokens": jx.jnp.asarray(toks[:, :8])})
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8])})
    for i in range(8, 12):
        lj, sj = jm.decode(jp, jx.jnp.asarray(toks[:, i:i + 1]), sj, jx.jnp.int32(i))
        lt, st = tm.decode(tp, torch.as_tensor(toks[:, i:i + 1]), st, i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {i}", **TOL)
        _close_states(st, sj)


def test_scheduler_tokens_match_reference_and_generate(jx, models):
    """Stacked per-slot state: 3 requests on 2 slots, so a slot is reused."""
    jm, jp, tm, tp = models
    jsched = jx.sched
    scfg = dict(max_slots=2, queue_capacity=4)
    prompts = [_tokens(10 + i, b=1, t=t)[0] for i, t in enumerate((16, 8, 32))]
    want = jsched.ContinuousBatchingServer(jm, jp, jsched.ServeConfig(**scfg)).run(
        [jsched.Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
         for i, p in enumerate(prompts)])
    server = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu")
    assert server.alloc is None and server.pools is None
    assert server.state["wkv"].shape[1] == 2
    server.warmup()
    got = server.run([Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
                      for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens
        gen, _ = generate(tm, tp, torch.as_tensor(p)[None], gen_len=6)
        assert gen[0].tolist() == got[f"r{i}"].tokens
    assert server.counters["prefills"] == 3


def test_serve_cli_scheduler_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler",
                "--requests", "2", "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "req0: ok" in out and "req1: ok" in out


def test_train_refuses_ssm_until_ported(capsys):
    """The launcher refused the ssm family until its training was ported;
    now it trains it: one step on the CPU with a finite loss."""
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                 "--batch", "2", "--seq", "16"])
    done = capsys.readouterr().out.split("[done]")[1]
    assert f"{ARCH} steps=1" in done and "device=cpu" in done
    assert np.isfinite(float(done.split("final_loss=")[1].split()[0]))


def test_tuned_chunk_condition_is_the_reference_one(models, monkeypatch):
    """The chunked WKV runs when wkv_chunked and T > 1 and T % wkv_chunk
    == 0; the scan otherwise (decode, ragged prompts)."""
    _, _, tm, tp = models
    calls = []
    real = trwkv._wkv_chunked
    monkeypatch.setattr(trwkv, "_wkv_chunked",
                        lambda *a, **k: calls.append(a[0].shape[1]) or real(*a, **k))
    for t in (16, 20, 1):
        tm.prefill(tp, {"tokens": torch.as_tensor(_tokens(3, t=t))})
    want = [16] * tm.cfg.num_layers if tm.cfg.wkv_chunked else []
    assert calls == want and tm.cfg.wkv_chunk == 16
