"""Port parity of Pixtral-12B (`repro_torch.models.vlm`, the vlm family).

Reduced Pixtral keeps the family's code paths at tiny widths: 2 layers,
d_model 64, 4 heads over 2 KV heads, 8 stub patches, f32.  The JAX
reference initialises the weights and `params_from_numpy` carries them
over; both packages run the same seeded numpy inputs, held within atol =
rtol = 1e-5 (f32; reduction orders differ).  Variants: head_dim 16 (the
reduced default, heads x hd = d_model), head_dim 32 (heads x hd = 128 !=
d_model = 64, as at full width: 32 x 128 = 4096 != 5120), and attn_chunk 8
(the chunked prefill over patches + text).

  * forward and prefill logits (text positions only) and caches (patches +
    text);
  * stepwise decode logits against padded dense caches, positions counted
    from the start of the patches + text stream;
  * the continuous-batching server on pages: the reference server's greedy
    tokens, and the port's own `generate`;
  * `launch/train.py` refuses the family, as the reference's does, and the
    serve CLI counts the patches into the pages.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "pixtral-12b"
VARIANTS = {"hd16": dict(), "hd32": dict(head_dim=32), "chunk8": dict(attn_chunk=8)}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.launch import scheduler
    from repro.models import get_model as get_mdl

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 sched=scheduler)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(jx, request):
    """(jax model, jax params, port model, port params) on the same weights."""
    kw = VARIANTS[request.param]
    jm = jx.get_model(dataclasses.replace(jx.get_config(ARCH).reduced(), **kw))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = get_model(dataclasses.replace(get_config(ARCH).reduced(), **kw))
    assert tm.cfg.num_stub_patches == 8 and tm.supports_paged
    assert jp["patch_proj"].shape == (64, 64)
    assert jp["blocks"]["attn"]["wq"].shape[-1] == tm.cfg.num_heads * tm.cfg.head_dim_
    return jm, jp, tm, params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")


def _batch(seed, b=2, t=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, t)).astype(np.int32),
            "patches": rng.normal(size=(b, 8, 64)).astype(np.float32)}


def test_forward_and_prefill_match_reference(jx, models):
    jm, jp, tm, tp = models
    batch = _batch(1)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    lj, _ = jm.forward(jp, jb)
    lt, _ = tm.forward(tp, tb)
    assert lt.shape == (2, 16, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    lj, cj = jm.prefill(jp, jb)
    lt, ct = tm.prefill(tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        assert ct[name].shape[2] == 8 + 16  # patches + text
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL)
    spec = tm.decode_state_specs(2, 20)["k"]
    assert spec[0] == jm.decode_state_specs(2, 20)["k"].shape == (2, 2, 28, 2, tm.cfg.head_dim_)


def test_stepwise_decode_matches_reference(jx, models):
    jm, jp, tm, tp = models
    jnp = jx.jnp
    batch = _batch(2, t=12)
    pre = {"tokens": batch["tokens"][:, :8], "patches": batch["patches"]}
    _, cj = jm.prefill(jp, {k: jnp.asarray(v) for k, v in pre.items()})
    _, ct = tm.prefill(tp, {k: torch.as_tensor(v) for k, v in pre.items()})
    cj = {k: jnp.pad(v, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]) for k, v in cj.items()}
    ct = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in ct.items()}
    full, _ = tm.forward(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    for i in range(8, 12):
        tok = batch["tokens"][:, i:i + 1]
        lj, cj = jm.decode(jp, jnp.asarray(tok), cj, jnp.int32(8 + i))
        lt, ct = tm.decode(tp, torch.as_tensor(tok), ct, 8 + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {i}", **TOL)
        torch.testing.assert_close(lt[:, 0], full[:, i], **TOL)


def test_scheduler_tokens_match_reference_and_generate(jx, models):
    """Paged decode over patches + text: 3 requests on 2 slots."""
    jm, jp, tm, tp = models
    jsched = jx.sched
    scfg = dict(max_slots=2, page_size=8, num_pages=13, max_pages_per_seq=6, queue_capacity=4)
    prompts = [np.random.default_rng(20 + i).integers(0, 256, t).astype(np.int32)
               for i, t in enumerate((16, 8, 24))]
    want = jsched.ContinuousBatchingServer(jm, jp, jsched.ServeConfig(**scfg)).run(
        [jsched.Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
         for i, p in enumerate(prompts)])
    server = ContinuousBatchingServer(tm, tp, ServeConfig(**scfg), device="cpu")
    got = server.run([Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=i)
                      for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert got[f"r{i}"].status == want[f"r{i}"].status == "ok"
        assert got[f"r{i}"].tokens == want[f"r{i}"].tokens
        gen, _ = generate(tm, tp, torch.as_tensor(p)[None], gen_len=6)
        assert gen[0].tolist() == got[f"r{i}"].tokens
    # A 24-token prompt needs ceil((8 + 24 + 6) / 8) = 5 pages: more than
    # max_pages_per_seq 4 sheds it, as the reference's server does.
    small = ContinuousBatchingServer(tm, tp, ServeConfig(**{**scfg, "max_pages_per_seq": 4}),
                                     device="cpu")
    small.submit(Request(rid="big", prompt=prompts[2], max_new_tokens=6))
    assert small.results["big"].reason == "too_long:block_table"


def test_train_refuses_vlm():
    with pytest.raises(SystemExit, match="token-LM families"):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1"])


def test_serve_cli_scheduler_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler",
                 "--requests", "2", "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "req0: ok" in out and "req1: ok" in out
    assert "pages=7x8" in out  # 1 + 2 slots x ceil((8 + 8 + 4) / 8)
