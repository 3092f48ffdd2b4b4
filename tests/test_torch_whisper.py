"""Port parity of Whisper-medium (`repro_torch.models.whisper`, the audio
family) and of cross-attention.

Reduced Whisper keeps the family's code paths at tiny widths: 2 encoder and
2 decoder layers, d_model 64, 4 heads over 2 KV heads, f32.  The JAX
reference initialises the weights and `params_from_numpy` carries them
over; both packages run the same seeded numpy inputs, held within atol =
rtol = 1e-5 (f32; reduction orders differ).  With attn_chunk 8 and 16
frames the encoder takes the chunked path, non-causal; with attn_chunk 0
plain `_sdpa`.

  * `attention` with `cross_kv`: only wq projects, nothing is rotated, no
    mask, and the cache arguments are ignored; `use_rope=False`;
  * forward and prefill logits, the encoder output and the decoder caches;
  * stepwise decode logits against padded caches (cross K/V recomputed
    from enc_out every step, as in the reference);
  * the serve CLI refuses the family, as the reference's does, and the
    scheduler rejects it.
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
from repro_torch.launch.scheduler import ContinuousBatchingServer, ServeConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.models import ShardCtx
    from repro.models import attention
    from repro.models import get_model as get_mdl

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 attention=attention, ShardCtx=ShardCtx)


# -- cross-attention ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cross", "cross_ignores_cache", "no_rope"])
def test_attention_modes_match_reference(jx, mode):
    jc = jx.get_config(ARCH).reduced()
    tc = get_config(ARCH).reduced()
    rng = np.random.default_rng(3)
    specs = jx.attention.attn_specs(jc)
    p = {k: rng.normal(size=s.shape).astype(np.float32) * 0.2 for k, s in specs.items()}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    kv = [rng.normal(size=(2, 11, 2, 16)).astype(np.float32) for _ in "kv"]
    jp = {k: jx.jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    kw_j, kw_t = {}, {}
    if mode.startswith("cross"):
        kw_j["cross_kv"] = tuple(jx.jnp.asarray(a) for a in kv)
        kw_t["cross_kv"] = tuple(torch.as_tensor(a) for a in kv)
    if mode == "cross_ignores_cache":
        kw_j.update(cache_pos=3, write_cache=True)
        kw_t.update(cache_pos=3, write_cache=True)
    if mode == "no_rope":
        kw_j["use_rope"] = kw_t["use_rope"] = False
    yj, cj = jx.attention.attention(jp, jx.jnp.asarray(x), jc, jx.ShardCtx(), **kw_j)
    yt, ct = tattn.attention(tp, torch.as_tensor(x), tc, **kw_t)
    assert ct is None and cj is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_cross_attention_rotates_nothing():
    """Cross-attention's output does not move with the query positions:
    rotating q against unrotated keys would make it (RoPE sits outside the
    cross branch)."""
    tc = get_config(ARCH).reduced()
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s.shape, generator=g) * 0.2
         for k, s in tattn.attn_specs(tc).items()}
    x = torch.randn(1, 3, 64, generator=g)
    kv = tuple(torch.randn(1, 7, 2, 16, generator=g) for _ in "kv")
    pos0, pos9 = torch.arange(3)[None], torch.arange(3)[None] + 9
    a = tattn.attention(p, x, tc, positions=pos0, cross_kv=kv)[0]
    b = tattn.attention(p, x, tc, positions=pos9, cross_kv=kv)[0]
    assert torch.equal(a, b)


# -- reduced Whisper end to end -----------------------------------------------------


@pytest.fixture(scope="module", params=[8, 0], ids=["chunk8", "full"])
def models(jx, request):
    """(jax model, jax params, port model, port params) on the same weights."""
    def cfg(c):
        return dataclasses.replace(c.reduced(), attn_chunk=request.param)

    jm = jx.get_model(cfg(jx.get_config(ARCH)))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = get_model(cfg(get_config(ARCH)))
    assert (tm.cfg.enc_layers, tm.cfg.dec_layers) == (2, 2)
    return jm, jp, tm, params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")


def _batch(seed, b=2, t=6, frames=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, t)).astype(np.int32),
            "frames": rng.normal(size=(b, frames, 64)).astype(np.float32)}


def test_forward_and_prefill_match_reference(jx, models, monkeypatch):
    jm, jp, tm, tp = models
    batch = _batch(1)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    lj, _ = jm.forward(jp, jb)
    calls = []
    real = fa.flash_attention_torch
    monkeypatch.setattr(fa, "flash_attention_torch",
                        lambda *a, **k: calls.append(k["causal"]) or real(*a, **k))
    lt, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # The encoder's 16 frames take the chunked path, non-causal, once a
    # layer; the 6-token decoder prompt does not.
    assert calls == ([False] * tm.cfg.enc_layers if tm.cfg.attn_chunk else [])
    lj, sj = jm.prefill(jp, jb)
    lt, st = tm.prefill(tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert set(st) == set(sj) == {"enc_out", "k", "v"}
    for name in sj:
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), err_msg=name, **TOL)
    specs = tm.decode_state_specs(2, 64)
    for name, s in jm.decode_state_specs(2, 64).items():
        assert specs[name][0] == s.shape


def test_stepwise_decode_matches_reference(jx, models):
    jm, jp, tm, tp = models
    jnp = jx.jnp
    batch = _batch(2, t=9)
    pre = {"tokens": batch["tokens"][:, :5], "frames": batch["frames"]}
    _, sj = jm.prefill(jp, {k: jnp.asarray(v) for k, v in pre.items()})
    _, st = tm.prefill(tp, {k: torch.as_tensor(v) for k, v in pre.items()})
    sj = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]) if k != "enc_out" else v)
          for k, v in sj.items()}
    st = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) if k != "enc_out" else v)
          for k, v in st.items()}
    full, _ = tm.forward(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    for i in range(5, 9):
        tok = batch["tokens"][:, i:i + 1]
        lj, sj = jm.decode(jp, jnp.asarray(tok), sj, jnp.int32(i))
        lt, st = tm.decode(tp, torch.as_tensor(tok), st, i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {i}", **TOL)
        torch.testing.assert_close(lt[:, 0], full[:, i], **TOL)


def test_serve_refuses_audio():
    with pytest.raises(SystemExit, match="frames batch"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="not schedulable"):
        ContinuousBatchingServer(get_model(get_config(ARCH).reduced()), None, ServeConfig(),
                                 device="cpu")
