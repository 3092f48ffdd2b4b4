"""The port's configs against the reference's, and the dense configs that
need no new model code.

  * the port registers the reference's eleven configs, and every one
    equals the reference's, field for field (every field the port's
    `ArchConfig` has), and so do `tuned()`, `reduced()`,
    `n_params_dense_blocks()` and `n_active_params()`;
  * `get_model` builds every config, with the reference's parameter specs;
  * Granite-3 8B reduced (tied embeddings, a vocab that `tuned()` pads):
    prefill and teacher-forced decode logits within 1e-5 of the reference's
    on both backend pairs, the padded rows never winning the argmax;
  * `pack_documents` equals the reference's.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import CONFIGS, get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data import pack_documents  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
DENSE_MOE = ["granite-3-8b", "mesh-paper", "mistral-large-123b", "olmoe-1b-7b",
             "phi3-medium-14b", "qwen2-7b", "qwen2-moe-a2.7b"]
ARCHS = sorted(DENSE_MOE + ["pixtral-12b", "rwkv6-1.6b", "whisper-medium", "zamba2-1.2b"])
FIELDS = [f.name for f in dataclasses.fields(ArchConfig)]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.data.pipeline import pack_documents as jpack
    from repro.models import get_model as get_mdl

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 pack=jpack)


def test_the_port_registers_seven_configs():
    """The seven dense and moe configs."""
    assert set(DENSE_MOE) <= set(CONFIGS)
    assert {get_config(a).family for a in DENSE_MOE} == {"dense", "moe"}


def test_the_port_registers_eleven_configs(jx):
    """Every config of the reference, the other four families included."""
    from repro.configs import CONFIGS as REF

    assert sorted(CONFIGS) == ARCHS == sorted(REF)
    assert {get_config(a).family for a in ARCHS} == {"dense", "moe", "ssm", "hybrid",
                                                       "audio", "vlm"}


@pytest.mark.parametrize("arch", ARCHS)
def test_get_model_builds_every_config(jx, arch):
    """`get_model` builds every published config, through `tuned()` too,
    and its parameter specs are the reference's: the same tree, shapes,
    init scales and logical axes, at full width (specs only, nothing is
    allocated)."""
    for variant in (lambda c: c, lambda c: c.tuned()):
        tm = get_model(variant(get_config(arch)))
        jm = jx.get_model(variant(jx.get_config(arch)))
        got, want = tm.specs(), jm.specs()
        flat = lambda t, pre="": (  # noqa: E731
            {pre: t} if not isinstance(t, dict)
            else {k: v for n, sub in t.items() for k, v in flat(sub, f"{pre}/{n}").items()})
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        for name in want:
            assert (got[name].shape, got[name].scale, got[name].init, got[name].axes) == (
                want[name].shape, want[name].scale, want[name].init, want[name].axes), name
        assert tm.supports_paged == jm.supports_paged


def _same(tc, jc):
    for name in FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.head_dim_ == jc.head_dim_ and tc.is_moe == jc.is_moe


@pytest.mark.parametrize("variant", ["published", "tuned", "reduced", "tuned_reduced", "tp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(jx, arch, variant):
    tc, jc = get_config(arch), jx.get_config(arch)
    if variant == "tuned":
        tc, jc = tc.tuned(), jc.tuned()
    elif variant == "reduced":
        tc, jc = tc.reduced(), jc.reduced()
    elif variant == "tuned_reduced":
        tc, jc = tc.tuned().reduced(), jc.tuned().reduced()
    elif variant == "tp8":
        tc, jc = tc.tuned(tp=8), jc.tuned(tp=8)
    _same(tc, jc)
    assert tc.n_params_dense_blocks() == jc.n_params_dense_blocks()
    assert tc.n_active_params() == jc.n_active_params()


def test_tuned_values():
    g = get_config("granite-3-8b").tuned()
    assert (g.attn_chunk, g.vocab_pad_multiple) == (1024, 256)  # 49155 % 16 != 0
    m = get_config("mistral-large-123b").tuned()
    assert (m.attn_chunk, m.vocab_pad_multiple) == (1024, 0)
    # The ssm family (RWKV) has no attention: the chunked WKV instead.
    r = get_config("rwkv6-1.6b").tuned()
    assert (r.wkv_chunked, r.attn_chunk, r.wkv_chunk) == (True, 0, 16)
    w = get_config("whisper-medium").tuned()
    assert (w.attn_chunk, w.vocab_pad_multiple, w.wkv_chunked) == (1024, 256, False)


def test_published_dense_configs_build_specs():
    """Granite, Phi-3 and Mistral at published width: GQA rep 4, 4 and 12,
    Granite's head tied (no lm_head) with its vocab padded to 49408."""
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.transformer import lm_specs

    for arch, rep in (("granite-3-8b", 4), ("phi3-medium-14b", 4), ("mistral-large-123b", 12)):
        cfg = get_config(arch).tuned()
        assert cfg.num_heads // cfg.num_kv_heads == rep
        specs = lm_specs(cfg)
        assert ("lm_head" in specs) == (not cfg.tie_embeddings)
        assert specs["embed"].shape == (padded_vocab(cfg), cfg.d_model)
    assert padded_vocab(get_config("granite-3-8b").tuned()) == 49408


# -- Granite reduced: tied head, padded vocab -----------------------------------

MESH = [False, True]


@pytest.fixture(scope="module", params=MESH, ids=["torch", "cuda_mesh"])
def granite(jx, request):
    """(jax model, jax params, port model, port params): tuned Granite,
    reduced, with a vocab of 250 that pads to 256 and attn_chunk 8 (the
    chunked prefill on 16-token prompts)."""
    def cfg(c):
        return dataclasses.replace(c.tuned().reduced(), vocab_size=250, attn_chunk=8,
                                   use_mesh_kernel=request.param)

    jm = jx.get_model(cfg(jx.get_config("granite-3-8b")))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    tm = get_model(cfg(get_config("granite-3-8b")))
    assert tm.cfg.tie_embeddings and "lm_head" not in tp and tp["embed"].shape[0] == 256
    return jm, jp, tm, tp


def test_granite_prefill_and_decode_logits_match_reference(jx, granite):
    jnp = jx.jnp
    jm, jp, tm, tp = granite
    toks = np.random.default_rng(5).integers(0, 250, (2, 16)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # Padded rows never win: they read -1e30 on both sides.
    assert (lt[..., 250:] == -1e30).all() and (lt.argmax(-1) < 250).all()
    # The tied head reads embed.T.
    torch.testing.assert_close(
        lt[..., :250], tm.forward(tp, {"tokens": torch.as_tensor(toks)})[0][..., :250])
    pad = lambda c, n: np.pad(np.asarray(c), ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))  # noqa: E731
    jstate = {k: jnp.asarray(pad(cj[k], 4)) for k in ("k", "v")}
    tstate = {k: torch.nn.functional.pad(ct[k], (0, 0, 0, 0, 0, 4)) for k in ("k", "v")}
    tok = np.argmax(np.asarray(lj)[:, -1], axis=-1).astype(np.int32)[:, None]
    for i in range(4):
        lgj, jstate = jm.decode(jp, jnp.asarray(tok), jstate, 16 + i)
        lgt, tstate = tm.decode(tp, torch.as_tensor(tok), tstate, 16 + i)
        np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), **TOL)
        tok = np.argmax(np.asarray(lgj)[:, -1], axis=-1).astype(np.int32)[:, None]


# -- pack_documents ----------------------------------------------------------------


@pytest.mark.parametrize("lengths,seq_len", [((5, 3, 9, 2), 8), ((1, 1, 1), 4),
                                             ((12,), 5), ((4, 4, 4, 4, 7), 8)])
def test_pack_documents_matches_reference(jx, lengths, seq_len):
    rng = np.random.default_rng(sum(lengths))
    docs = [rng.integers(1, 100, n).astype(np.int32) for n in lengths]
    got, want = pack_documents(docs, seq_len, pad_id=0), jx.pack(docs, seq_len, pad_id=0)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
