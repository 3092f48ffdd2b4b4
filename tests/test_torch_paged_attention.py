"""Port parity: paged decode attention (K4) and its capability door.

The plain version `paged_attention_torch` (the `torch_gather` impl) is held
against the reference's `paged_attention_xla` and `paged_attention_pallas`
(interpret mode) on the same numpy inputs; tolerance atol = 2e-6 in f32,
the reference's own bound between its two impls (softmax and reduction
orders differ).  Inside the port it must equal the dense `_sdpa` bitwise.
The CUDA kernel is held against the plain version in the tests marked for
the card (skipped without one) and in chip_smoke.py.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.api import CapabilityError  # noqa: E402
from repro_torch.models.attention import _sdpa  # noqa: E402

ATOL = 2e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import paged_attention

    return types.SimpleNamespace(jnp=jnp, pa=paged_attention)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _setup(seed=0, *, s=3, h=4, kvh=2, hd=16, ps=8, n_pages=4, lengths=(5, 17, 32)):
    rng = np.random.default_rng(seed)
    pool_pages = 1 + s * n_pages
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k_pool = rng.standard_normal((pool_pages, ps, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((pool_pages, ps, kvh, hd)).astype(np.float32)
    # Non-contiguous per-slot page sets, every id >= 1 (0 is scratch).
    bt = rng.permutation(np.arange(1, pool_pages))[: s * n_pages].reshape(s, n_pages)
    return q, k_pool, v_pool, bt.astype(np.int32), np.asarray(lengths, np.int32)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _jax(jx, arrays):
    return [jx.jnp.asarray(x) for x in arrays]


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2), (6, 1)])
@pytest.mark.parametrize("lengths", [(5, 17, 32), (1, 9, 12), (3, 8, 21)])
def test_plain_matches_reference_impls(jx, h, kvh, lengths):
    """GQA ratios 1, 2, 4 (and 6), tails that end inside a page, and pages
    past the length (which the Pallas kernel skips)."""
    arrays = _setup(h=h, kvh=kvh, lengths=lengths)
    got = pa.paged_attention_torch(*_torch(arrays)).numpy()
    want_x = np.asarray(jx.pa.paged_attention_xla(*_jax(jx, arrays)))
    want_p = np.asarray(jx.pa.paged_attention_pallas(*_jax(jx, arrays), interpret=True))
    assert got.shape == arrays[0].shape
    np.testing.assert_allclose(got, want_x, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_p, atol=ATOL, rtol=0)


def test_plain_bitwise_matches_dense_sdpa():
    q, kp, vp, bt, ln = _torch(_setup())
    out = pa.paged_attention_torch(q, kp, vp, bt, ln)
    k, v = pa.gather_pages(kp, bt), pa.gather_pages(vp, bt)
    ref = _sdpa(q[:, None], k, v, causal=False, kv_valid_len=ln[:, None])
    assert torch.equal(out, ref[:, 0])


def test_gather_pages_matches_reference(jx):
    _, kp, _, bt, _ = _setup()
    got = pa.gather_pages(torch.from_numpy(kp), torch.from_numpy(bt))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx.pa.gather_pages(jx.jnp.asarray(kp), jx.jnp.asarray(bt)))
    )


def test_length_masking_ignores_tail_and_unused_pages():
    """Poisoning every pool row past `lengths` (and page 0) must not change
    the output."""
    q, kp, vp, bt, _ = _setup()
    ln = np.asarray([1, 9, 12], np.int32)
    base = pa.paged_attention_torch(*_torch((q, kp, vp, bt, ln)))
    ps = kp.shape[1]
    k2, v2 = kp.copy(), vp.copy()
    for slot in range(bt.shape[0]):
        for pidx in range(bt.shape[1]):
            for off in range(ps):
                if pidx * ps + off >= ln[slot]:
                    k2[bt[slot, pidx], off] = 7e5
                    v2[bt[slot, pidx], off] = -7e5
    k2[0] = v2[0] = 9e5  # scratch page
    poisoned = pa.paged_attention_torch(*_torch((q, k2, v2, bt, ln)))
    assert torch.equal(base, poisoned)


def test_shape_validation():
    q, kp, vp, bt, ln = _torch(_setup())
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_torch(q[..., :8], kp, vp, bt, ln)
    with pytest.raises(ValueError, match="k/v pool"):
        pa.paged_attention_torch(q, kp, vp[:4], bt, ln)
    with pytest.raises(ValueError, match="slots"):
        pa.paged_attention_torch(q, kp, vp, bt[:2], ln)


# -- capability door -----------------------------------------------------------


def test_door_resolves_by_device():
    assert pa.resolve_paged_impl() == "torch_gather"
    assert pa.resolve_paged_impl(device="cpu") == "torch_gather"
    assert pa.resolve_paged_impl(device="cuda") == "cuda_paged"
    assert pa.resolve_paged_impl("torch_gather", device="cpu") == "torch_gather"


def test_door_explicit_cuda_paged_on_cpu_raises_capability_error():
    with pytest.raises(CapabilityError):
        pa.resolve_paged_impl("cuda_paged", device="cpu")
    q, kp, vp, bt, ln = _torch(_setup())
    with pytest.raises(CapabilityError):
        pa.paged_attention(q, kp, vp, bt, ln, impl="cuda_paged")
    with pytest.raises(CapabilityError):
        pa.paged_attention_cuda(q, kp, vp, bt, ln)


def test_door_unknown_impl_and_duplicate_registration():
    with pytest.raises(ValueError, match="unknown paged impl"):
        pa.resolve_paged_impl("nope")
    with pytest.raises(ValueError, match="already registered"):
        pa.register_paged_impl("torch_gather", pa.paged_attention_torch, devices={"cpu"})
    pa.register_paged_impl(
        "torch_gather", pa.paged_attention_torch, devices={"cpu", "cuda"}, override=True
    )


def test_door_dispatch_on_cpu_is_the_plain_version():
    arrays = _torch(_setup())
    assert torch.equal(pa.paged_attention(*arrays), pa.paged_attention_torch(*arrays))


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("h,kvh,lengths", [(4, 4, (5, 17, 32)), (8, 2, (1, 9, 12)),
                                           (16, 4, (3, 8, 21))])
def test_kernel_matches_plain_on_card(cuda, h, kvh, lengths):
    arrays = [t.to(cuda) for t in _torch(_setup(h=h, kvh=kvh, lengths=lengths))]
    before = pa.paged_attention_cuda.launches
    got = pa.paged_attention(*arrays)  # the door picks cuda_paged on the card
    want = pa.paged_attention_torch(*arrays)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["long and short", "split boundary"])
def test_kernel_many_splits_match_plain_on_card(cuda, case):
    # A 300-page table on 2 slots x 4 KV heads: dozens of splits, most of
    # them empty for the short slot; or lengths on a split boundary and one
    # token past it.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    run = pa.split_plan(300, 2 * 4, sms)[0] * 8
    lengths = (2300, 17) if case == "long and short" else (20 * run, 20 * run + 1)
    arrays = [t.to(cuda) for t in _torch(_setup(s=2, h=28, kvh=4, hd=128, n_pages=300,
                                                  lengths=lengths))]
    before = pa.paged_attention_cuda.launches
    got = pa.paged_attention_cuda(*arrays)
    want = pa.paged_attention_torch(*arrays)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_rep_12_matches_plain_on_card(cuda, dtype):
    """mistral-large-123b's decode fold, 96 query heads over 8 KV heads (rep
    12, run as chunks of 8 and 4 rows): K4 against the plain version, f32 to
    1e-5 of the output's scale, bf16 to 2^-6 (p rounded to bf16 at other
    points, a bf16 output)."""
    arrays = _torch(_setup(s=2, h=96, kvh=8, hd=128, n_pages=40, lengths=(300, 17)))
    arrays = [t.to(cuda, dtype) if t.is_floating_point() else t.to(cuda) for t in arrays]
    before = pa.paged_attention_cuda.launches
    got = pa.paged_attention_cuda(*arrays)
    want = pa.paged_attention_torch(*arrays)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    limit = 1e-5 if dtype == torch.float32 else 2.0**-6
    err = (got.float() - want.float()).abs().max().item()
    assert err <= limit * want.float().abs().max().item(), err
