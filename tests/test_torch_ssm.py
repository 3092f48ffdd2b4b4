"""Port parity of Mamba2's SSD and the Zamba2 hybrid (`repro_torch.models.ssm`).

The same seeded numpy inputs and JAX-initialised weights (carried over by
`params_from_numpy`) go through both packages; f32, held within atol = rtol
= 1e-5 (reduction orders differ; `dt`'s softplus is torch's, which returns
x itself above 20 where the reference adds log1p(exp(-x)): under 1e-8
relative, far inside the limit):

  * `ssd_scan`, `ssd_chunked` and per-token `ssd_step` against the
    reference's at tests/test_ssd.py's (T, chunk) pairs (16, 4), (16, 16),
    (20, 8), (7, 4), (64, 16) — ragged T pads to the chunk — and with
    extreme decay (dt x 50), where the chunked form equals the scan;
  * reduced Zamba2 (4 Mamba layers, shared block every 2), and with a tail
    (5 layers) and the shared block's chunked attention: forward and
    prefill logits and states with the chunked SSD and the scan, stepwise
    decode logits and states against padded KV caches, and decode against
    the port's forward;
  * `generate` grows only the KV caches, and equals the reference's greedy
    decode; the scheduler rejects the family, as the reference's does.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, ServeConfig  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.models import get_model as get_mdl
    from repro.models import ssm

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 ssm=ssm)


# -- the SSD core -----------------------------------------------------------------


def _inputs(b, t, h, p, n, seed, dt_scale=1.0):
    """tests/test_ssd.py's inputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = (rng.random((b, t, h)) * dt_scale + 0.01).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.5
    bmat = rng.normal(size=(b, t, n)).astype(np.float32)
    cmat = rng.normal(size=(b, t, n)).astype(np.float32)
    d_skip = rng.normal(size=(h,)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) * 0.1
    return x, dt, a_log, bmat, cmat, d_skip, h0


PAIRS = [(16, 4), (16, 16), (20, 8), (7, 4), (64, 16)]


@pytest.mark.parametrize("t,chunk", PAIRS)
def test_ssd_matches_reference(jx, t, chunk):
    args = _inputs(2, t, 3, 4, 5, seed=t * 31 + chunk)
    for name, kw in (("ssd_scan", {}), ("ssd_chunked", dict(chunk=chunk))):
        yj, hj = getattr(jx.ssm, name)(*(jx.jnp.asarray(a) for a in args), **kw)
        yt, ht = getattr(tssm, name)(*(torch.as_tensor(a) for a in args), **kw)
        assert yt.shape == (2, t, 3, 4)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), err_msg=name, **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), err_msg=name, **TOL)


@pytest.mark.parametrize("t,chunk", PAIRS)
def test_ssd_chunked_equals_scan(t, chunk):
    """tests/test_ssd.py's equivalence, in the port (its limit, 2e-4: the
    chunked form sums in another order than the scan)."""
    args = [torch.as_tensor(a) for a in _inputs(2, t, 3, 4, 5, seed=t * 31 + chunk)]
    y_seq, h_seq = tssm.ssd_scan(*args)
    y_chk, h_chk = tssm.ssd_chunked(*args, chunk=chunk)
    torch.testing.assert_close(y_chk, y_seq, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h_chk, h_seq, rtol=2e-4, atol=2e-4)


def test_ssd_step_matches_reference_per_token(jx):
    x, dt, a_log, bmat, cmat, d_skip, h0 = _inputs(2, 6, 2, 3, 4, seed=5)
    hj, ht = jx.jnp.asarray(h0), torch.as_tensor(h0)
    for i in range(6):
        step = (x[:, i], dt[:, i], a_log, bmat[:, i], cmat[:, i], d_skip)
        yj, hj = jx.ssm.ssd_step(hj, *(jx.jnp.asarray(a) for a in step))
        yt, ht = tssm.ssd_step(ht, *(torch.as_tensor(a) for a in step))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


def test_ssd_extreme_decay(jx):
    """dt x 50: decays underflow to 0 but nothing overflows."""
    args = _inputs(1, 32, 2, 3, 4, seed=0, dt_scale=50.0)
    yj, hj = jx.ssm.ssd_chunked(*(jx.jnp.asarray(a) for a in args), chunk=8)
    yt, ht = tssm.ssd_chunked(*(torch.as_tensor(a) for a in args), chunk=8)
    assert torch.isfinite(yt).all() and torch.isfinite(ht).all()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    y_seq, h_seq = tssm.ssd_scan(*(torch.as_tensor(a) for a in args))
    torch.testing.assert_close(yt, y_seq, rtol=1e-3, atol=1e-3)  # tests/test_ssd.py's limit


def test_split_proj_takes_indices(jx):
    """jnp.split takes indices where torch.split takes sizes: `_split_proj`
    cuts at the reference's indices (tensor_split)."""
    cfg = get_config(ARCH).reduced()
    width = 2 * cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state_size + cfg.ssm_num_heads
    z = np.arange(2 * width, dtype=np.float32).reshape(1, 2, width)
    got = tssm._split_proj(cfg, torch.as_tensor(z))
    want = jx.ssm._split_proj(jx.get_config(ARCH).reduced(), jx.jnp.asarray(z))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- reduced Zamba2 end to end ------------------------------------------------------

VARIANTS = {
    "base": dict(),
    # 2 segments of 2 and a 1-layer tail; 16-token prompts take the shared
    # block's chunked attention
    "tail": dict(num_layers=5, attn_chunk=8),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(jx, request):
    """(jax model, jax params, port model, port params) on the same weights."""
    kw = VARIANTS[request.param]
    jm = jx.get_model(dataclasses.replace(jx.get_config(ARCH).reduced(), **kw))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = get_model(dataclasses.replace(get_config(ARCH).reduced(), **kw))
    assert tm.cfg.shared_attn_period == 2
    assert ("mamba_tail" in jp) == (request.param == "tail")
    # One trace per shape: the reference's decode steps run jitted.
    jm = dataclasses.replace(jm, _decode=jx.jax.jit(jm._decode, static_argnums=(4, 5)))
    return jm, jp, tm, params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, b=2, t=16):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _close(got, want, msg=""):
    assert set(got) == set(want), (set(got), set(want))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=f"{msg} {name}", **TOL)


@pytest.mark.parametrize("chunked", [True, False])
def test_forward_and_prefill_match_reference(jx, models, chunked):
    jm, jp, tm, tp = models
    toks = _tokens(1, t=16)
    jit = jx.jax.jit
    lj, _ = jit(lambda p, t: jx.ssm.zamba_forward(p, t, jm.cfg, chunked=chunked))(
        jp, jx.jnp.asarray(toks))
    lt, _ = tssm.zamba_forward(tp, torch.as_tensor(toks), tm.cfg, chunked=chunked)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    lj, sj = jit(lambda p, t: jx.ssm.zamba_prefill(p, t, jm.cfg, chunked=chunked))(
        jp, jx.jnp.asarray(toks))
    lt, st = tssm.zamba_prefill(tp, torch.as_tensor(toks), tm.cfg, chunked=chunked)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _close(st, sj)
    assert st["conv"].shape[2] == 3 and st["h"].dtype == torch.float32


def test_state_specs_match_reference(jx, models):
    jm, jp, tm, tp = models
    specs = tm.decode_state_specs(2, 40)
    for name, s in jm.decode_state_specs(2, 40).items():
        assert specs[name][0] == s.shape and str(specs[name][1]) == f"torch.{s.dtype}"


def _pad_kv(state, n, pad):
    return {k: (pad(v, n) if k in ("kv_k", "kv_v") else v) for k, v in state.items()}


def test_stepwise_decode_matches_reference_and_forward(jx, models):
    """Prefill 8 tokens, decode 4 against KV caches padded by 4 (the
    recurrent h and conv carried as they are), in both packages: logits and
    states agree each step, and the port's decode equals its forward."""
    jm, jp, tm, tp = models
    jnp = jx.jnp
    toks = _tokens(3, t=12)
    _, sj = jx.jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :8])})
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8])})
    sj = _pad_kv(sj, 4, lambda v, n: jnp.pad(v, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)]))
    st = _pad_kv(st, 4, lambda v, n: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n)))
    full, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    for i in range(8, 12):
        lj, sj = jm.decode(jp, jnp.asarray(toks[:, i:i + 1]), sj, jnp.int32(i))
        lt, st = tm.decode(tp, torch.as_tensor(toks[:, i:i + 1]), st, i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {i}", **TOL)
        _close(st, sj, f"step {i}")
        torch.testing.assert_close(lt[:, 0], full[:, i], **TOL)


def test_generate_grows_only_kv_and_matches_reference(jx, models):
    """`generate` pads kv_k/kv_v and leaves h and conv alone; its tokens are
    the reference's greedy decode on the same padded state."""
    jm, jp, tm, tp = models
    jnp = jx.jnp
    toks = _tokens(4, t=8)
    got, _ = generate(tm, tp, torch.as_tensor(toks), gen_len=5)
    lj, sj = jx.jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    sj = _pad_kv(sj, 5, lambda v, n: jnp.pad(v, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)]))
    tok = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(4):
        lj, sj = jm.decode(jp, tok[:, None], sj, jnp.int32(8 + i))
        tok = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_scheduler_rejects_hybrid():
    with pytest.raises(NotImplementedError, match="not schedulable"):
        ContinuousBatchingServer(get_model(get_config(ARCH).reduced()), None, ServeConfig(),
                                 device="cpu")


def test_train_refuses_hybrid_until_ported(capsys):
    """The launcher refused the hybrid family until its training was ported;
    now it trains it: one step on the CPU with a finite loss."""
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                 "--batch", "2", "--seq", "16"])
    done = capsys.readouterr().out.split("[done]")[1]
    assert f"{ARCH} steps=1" in done and "device=cpu" in done
    assert np.isfinite(float(done.split("final_loss=")[1].split()[0]))
