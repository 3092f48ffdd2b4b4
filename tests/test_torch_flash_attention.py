"""Port parity: flash attention (K6) and the chunked attention path.

The port's `flash_attention` on CPU tensors runs its plain version (the
port's `_sdpa_chunked` with chunk = block_k); it is held against the
reference's three implementations of one semantics on the same numpy
inputs: `flash_attention_pallas` in interpret mode, `_sdpa` and
`_sdpa_chunked`.  Tolerances are the reference's own
(tests/test_flash_kernel.py): rtol = atol = 2e-5 in f32 (softmax and
reduction orders differ), 3e-2 in bf16 (probabilities and outputs round to
bf16 at different points).  Gradients: autograd through the port's chunked
path, and `_FlashAttention`'s recompute backward (the one K6 runs under on
the card), against `jax.grad` of the reference's `_sdpa_chunked`, within
1e-5 of the largest gradient (f32).  K6 itself is held against the plain
version in the tests marked for the card (skipped without one) and in
chip_smoke.py.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import _sdpa_chunked  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# b, t, h, kv, hd, block_q, block_k: the reference's cases (MHA, GQA rep 2,
# rep 3, MQA).
CASES = [
    (2, 64, 4, 4, 16, 16, 16),
    (2, 64, 4, 2, 16, 16, 32),
    (1, 128, 6, 2, 32, 32, 64),
    (2, 64, 8, 1, 16, 64, 16),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import attention

    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas=flash_attention_pallas,
                                 sdpa=attention._sdpa, chunked=attention._sdpa_chunked)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _qkv(b, t, h, kv, hd, seed=0, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return (rng.normal(size=(b, t, h, hd)).astype(np.float32),
            rng.normal(size=(b, tk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, tk, kv, hd)).astype(np.float32))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=dtype) for x in arrays]


@pytest.mark.parametrize("b,t,h,kv,hd,bq,bk", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_impls(jx, b, t, h, kv, hd, bq, bk, causal):
    arrays = _qkv(b, t, h, kv, hd, seed=t + h)
    before = fa.flash_attention.launches
    got = fa.flash_attention(*_torch(arrays), causal=causal, block_q=bq, block_k=bk).numpy()
    assert fa.flash_attention.launches == before  # CPU tensors: the plain version
    jarr = [jx.jnp.asarray(x) for x in arrays]
    want = {
        "pallas": jx.pallas(*jarr, causal=causal, block_q=bq, block_k=bk, interpret=True),
        "sdpa": jx.sdpa(*jarr, causal=causal),
        "sdpa_chunked": jx.chunked(*jarr, causal=causal, chunk=bk),
    }
    assert got.shape == arrays[0].shape
    for name, ref in want.items():
        np.testing.assert_allclose(got, np.asarray(ref), **TOL, err_msg=name)


def test_flash_attention_bf16_matches_reference_impls(jx):
    arrays = _qkv(2, 64, 4, 2, 16)
    got = fa.flash_attention(*_torch(arrays, torch.bfloat16), causal=True, block_q=16,
                             block_k=16)
    assert got.dtype == torch.bfloat16
    jarr = [jx.jnp.asarray(x, jx.jnp.bfloat16) for x in arrays]
    for ref in (jx.pallas(*jarr, causal=True, block_q=16, block_k=16, interpret=True),
                jx.sdpa(*jarr, causal=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   **BF16_TOL)


@pytest.mark.parametrize("bq,bk,t,tk,causal", [
    (48, 16, 64, 64, True),  # Tq*rep % block_q (the reference's case)
    (16, 24, 64, 64, False),  # Tk % block_k
])
def test_flash_attention_rejects_bad_blocks(bq, bk, t, tk, causal):
    q, k, v = _torch(_qkv(1, t, 2, 2, 16, tk=tk))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)


def test_flash_attention_full_takes_other_key_length(jx):
    """Non-causal attention reads a key length other than Tq (the
    reference's kernel takes it too)."""
    arrays = _qkv(1, 32, 4, 2, 16, seed=5, tk=64)
    got = fa.flash_attention(*_torch(arrays), causal=False, block_q=16, block_k=16).numpy()
    want = jx.sdpa(*[jx.jnp.asarray(x) for x in arrays], causal=False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("tq,tk", [(32, 64), (64, 32)])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_other_key_length_matches_reference(jx, tq, tk, h, kv, dtype):
    """Causal attention with Tq != Tk (rep 1 and 2): the reference's kernel
    and chunked path compute it with a top-left mask (query token t sees
    keys 0..t), and so does the port."""
    arrays = _qkv(1, tq, h, kv, 16, seed=tq + h, tk=tk)
    tdt, jdt = getattr(torch, dtype), getattr(jx.jnp, dtype)
    got = fa.flash_attention(*_torch(arrays, tdt), causal=True, block_q=16, block_k=16)
    assert got.dtype == tdt and got.shape == arrays[0].shape
    jarr = [jx.jnp.asarray(x, jdt) for x in arrays]
    want = {
        "pallas": jx.pallas(*jarr, causal=True, block_q=16, block_k=16, interpret=True),
        "sdpa_chunked": jx.chunked(*jarr, causal=True, chunk=16),
    }
    for name, ref in want.items():
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   **(TOL if dtype == "float32" else BF16_TOL), err_msg=name)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_chunked_matches_reference(jx, chunk, dtype):
    """Op for op: f32 exactly to rounding; bf16 within the bf16 limit."""
    arrays = _qkv(2, 64, 4, 2, 16, seed=chunk)
    tdt, jdt = getattr(torch, dtype), getattr(jx.jnp, dtype)
    for causal in (True, False):
        got = _sdpa_chunked(*_torch(arrays, tdt), causal=causal, chunk=chunk)
        want = jx.chunked(*[jx.jnp.asarray(x, jdt) for x in arrays], causal=causal, chunk=chunk)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **(TOL if dtype == "float32" else BF16_TOL))


def _jax_grads(jx, arrays, ct, causal, chunk):
    def f(q, k, v):
        out = jx.chunked(q, k, v, causal=causal, chunk=chunk)
        return (out * ct).sum()

    return jx.jax.grad(f, argnums=(0, 1, 2))(*[jx.jnp.asarray(x) for x in arrays])


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (6, 1)])
def test_chunked_path_gradients_match_jax_grad(jx, causal, h, kv):
    """Autograd through the port's `flash_attention` on the CPU (the
    chunked recurrence) against jax.grad of the reference's."""
    arrays = _qkv(2, 32, h, kv, 16, seed=h)
    ct = np.random.default_rng(9).normal(size=arrays[0].shape).astype(np.float32)
    qkv = [t.requires_grad_(True) for t in _torch(arrays)]
    out = fa.flash_attention(*qkv, causal=causal, block_q=8, block_k=8)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(ct))
    _assert_grads(got, _jax_grads(jx, arrays, ct, causal, 8))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_recompute_backward_matches_jax_grad(jx, causal):
    """`_FlashAttention` with the plain forward: its backward (the one K6
    runs under on the card) recomputes the chunked path and gives
    jax.grad's gradients; the forward's output is the plain version's."""
    arrays = _qkv(1, 64, 6, 2, 16, seed=3)
    ct = np.random.default_rng(4).normal(size=arrays[0].shape).astype(np.float32)
    qkv = [t.requires_grad_(True) for t in _torch(arrays)]

    def plain(q, k, v, c):
        return fa.flash_attention_torch(q, k, v, causal=c, block_q=16, block_k=16)

    out = fa._FlashAttention.apply(*qkv, causal, 16, plain)
    assert out.grad_fn is not None
    with torch.no_grad():
        np.testing.assert_array_equal(out.detach().numpy(), plain(*qkv, causal).numpy())
    got = torch.autograd.grad(out, qkv, torch.from_numpy(ct))
    _assert_grads(got, _jax_grads(jx, arrays, ct, causal, 16))


def test_kernel_refuses_cpu_tensors():
    q, k, v = _torch(_qkv(1, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("b,t,h,kv,hd,bq,bk", CASES + [(1, 96, 14, 2, 128, 7, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda, b, t, h, kv, hd, bq, bk, causal):
    """K6 against its plain version, f32 on both (no TF32 in either): the
    summation order differs only, 1e-5 of max|v|."""
    q, k, v = _torch(_qkv(b, t, h, kv, hd, seed=t + h), device=cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    want = fa.flash_attention_torch(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * v.abs().max().item(), err


def test_kernel_bf16_matches_plain_on_card(cuda):
    """bf16 on the tensor-core kernel, rep 7 (Qwen2-7B's fold), 2^-6 of
    max|v|: p rounds to bf16 relative to other running maxima, the plain
    version rounds each chunk's P.V to bf16, and the output is bf16."""
    q, k, v = _torch(_qkv(1, 256, 28, 4, 128, seed=7), torch.bfloat16, cuda)
    got = fa.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    want = fa.flash_attention_torch(q, k, v, causal=True, block_q=128, block_k=128)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0**-6 * v.float().abs().max().item(), err


@pytest.mark.parametrize("tq,tk", [(64, 192), (192, 64)])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_causal_other_key_length_on_card(cuda, tq, tk, h, kv, dtype):
    """Causal K6 with Tq != Tk on the card against the plain version (the
    reference's top-left mask): f32 to 1e-5 of max|v|, bf16 to 2^-6."""
    tdt = getattr(torch, dtype)
    q, k, v = _torch(_qkv(1, tq, h, kv, 64, seed=tq + h, tk=tk), tdt, cuda)
    got = fa.flash_attention(q, k, v, causal=True, block_q=32, block_k=32)
    want = fa.flash_attention_torch(q, k, v, causal=True, block_q=32, block_k=32)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    limit = 1e-5 if dtype == "float32" else 2.0**-6
    assert err <= limit * v.float().abs().max().item(), err


def test_kernel_gradients_on_card(cuda):
    """On the card, gradients flow through `_FlashAttention` (never None)
    and equal autograd of the plain version within 1e-5 of their largest."""
    arrays = _qkv(1, 64, 4, 2, 32, seed=11)
    ct = torch.randn(1, 64, 4, 32, generator=torch.Generator().manual_seed(0)).to(cuda)
    qkv = [t.requires_grad_(True) for t in _torch(arrays, device=cuda)]
    got = torch.autograd.grad(fa.flash_attention(*qkv, block_q=16, block_k=16), qkv, ct)
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(fa.flash_attention_torch(*ref, block_q=16, block_k=16), ref, ct)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_kernel_rejects_head_dim_on_card(cuda):
    q, k, v = _torch(_qkv(1, 16, 2, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)
    # bf16 runs whole 16-deep mma steps: hd 24 (a multiple of 8) is refused.
    q, k, v = _torch(_qkv(1, 16, 2, 2, 24), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)
