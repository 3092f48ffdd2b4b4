"""Port parity: rmsnorm and its kernel R1 (`kernels/rmsnorm.py`).

R1 is a kernel of the port alone: the reference computes rmsnorm in XLA
(`repro.models.layers.rmsnorm`).  On CPU and meta tensors the door runs the
plain version, `rmsnorm_torch`, which is held against the reference's
rmsnorm on the same numpy inputs: within 1e-6 relative in f32 (XLA's CPU
mean and torch's sum in other orders) and within one ulp of the output in
bf16.  `_RMSNorm`'s recompute backward (the one R1 runs under on the card)
is held against `jax.grad` within 1e-6 of the largest gradient (f32).  On
the card (tests marked by the `cuda` fixture, skipped without one) R1 is
held against the plain version and read for batch invariance: each row of
a call at 1, 2, 3, 4, 8, 64 or 4096 rows bitwise equal to the same row
normalised alone.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import rmsnorm as rn  # noqa: E402

# d of every ArchConfig the port runs, and a ragged one (the scalar path).
WIDTHS = (64, 1024, 1536, 2048, 3584, 4096, 5120, 12288, 100)
EPS = 1e-5


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * rng.uniform(0.1, 4.0, size=(rows, 1))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    return x, gamma


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (f32)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.fixture
def cuda():
    """The card, or skip (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (R1 is a CUDA kernel; chip_smoke.py holds it)")
    return torch.device("cuda")


def test_door_runs_plain_version_on_cpu_and_meta():
    x, g = (torch.from_numpy(a) for a in _inputs(3, 64, 0))
    before = rn.rmsnorm_cuda.launches
    assert torch.equal(rn.rmsnorm(x, g, EPS), rn.rmsnorm_torch(x, g, EPS))
    meta = rn.rmsnorm(x.to("meta", torch.bfloat16), g.to("meta"), EPS)
    assert meta.device.type == "meta" and meta.shape == x.shape and meta.dtype == torch.bfloat16
    assert rn.rmsnorm_cuda.launches == before
    with pytest.raises(ValueError):
        rn.rmsnorm_cuda(x, g, EPS)
    from repro_torch.models import layers

    assert torch.equal(layers.rmsnorm(x, g, EPS), rn.rmsnorm_torch(x, g, EPS))


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_version_matches_reference(d):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import rmsnorm as jrmsnorm

    x, g = _inputs(6, d, d)
    want = np.asarray(jrmsnorm(jnp.asarray(x), jnp.asarray(g), EPS))
    got = rn.rmsnorm_torch(torch.from_numpy(x), torch.from_numpy(g), EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # bf16 activations and parameters: one output ulp.
    xb, gb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(jrmsnorm(xb, gb, EPS).astype(jnp.float32)))
    got = rn.rmsnorm_torch(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(), EPS)
    assert bool(((got.float() - want).abs() <= _bf16_ulp(want)).all())


def test_recompute_backward_matches_jax_grad():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.layers import rmsnorm as jrmsnorm

    x, g = _inputs(2 * 5, 96, 3)
    x = x.reshape(2, 5, 96)
    ct = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    jdx, jdg = jax.grad(lambda a, b: jnp.sum(jrmsnorm(a, b, EPS) * ct), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    out = rn._RMSNorm.apply(xt, gt, EPS, rn.rmsnorm_torch)
    assert torch.equal(out, rn.rmsnorm_torch(xt, gt, EPS))
    (out * torch.from_numpy(ct)).sum().backward()
    for got, want in ((xt.grad, jdx), (gt.grad, jdg)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # Only the inputs that need a gradient get one.
    xt = torch.from_numpy(x).requires_grad_(True)
    rn._RMSNorm.apply(xt, torch.from_numpy(g), EPS, rn.rmsnorm_torch).sum().backward()
    assert xt.grad is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_matches_plain_on_card(cuda, d, dtype):
    dt = getattr(torch, dtype)
    x, g = (torch.from_numpy(a).to(cuda, dt) for a in _inputs(37, d, d + 1))
    got, want = rn.rmsnorm(x, g, EPS), rn.rmsnorm_torch(x, g, EPS)
    torch.cuda.synchronize()
    if dt == torch.float32:
        assert ((got - want).abs() <= 1e-6 * want.abs().clamp_min(1e-30)).all()
    else:
        assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_element_loads_on_card(cuda, dtype):
    """R1's element-by-element loads: an odd d against the plain version,
    and rows one element into their storage bitwise the aligned rows."""
    dt = getattr(torch, dtype)
    for d in (1001, 2048):
        x, g = (torch.from_numpy(a).to(cuda, dt) for a in _inputs(37, d, d + 2))
        buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
        shifted = buf[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        got, want = rn.rmsnorm(shifted, g, EPS), rn.rmsnorm_torch(x, g, EPS)
        assert torch.equal(got, rn.rmsnorm(x, g, EPS))
        if dt == torch.float32:
            assert ((got - want).abs() <= 1e-6 * want.abs().clamp_min(1e-30)).all()
        else:
            assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all())


def test_kernel_is_batch_invariant_on_card(cuda):
    for d in (2048, 5120):
        for rows in (1, 2, 3, 4, 8, 64, 4096):
            x, g = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                    for a in _inputs(rows, d, rows))
            whole = rn.rmsnorm(x, g, EPS)
            for r in {0, rows // 2, rows - 1}:
                assert torch.equal(whole[r], rn.rmsnorm(x[r:r + 1], g, EPS)[0]), (d, rows, r)


def test_kernel_gradients_on_card(cuda):
    x, g = (torch.from_numpy(a).to(cuda) for a in _inputs(8, 256, 9))
    xs, gs = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    xp, gp = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    before = rn.rmsnorm_cuda.launches
    rn.rmsnorm(xs, gs, EPS).square().sum().backward()
    rn.rmsnorm_torch(xp, gp, EPS).square().sum().backward()
    assert rn.rmsnorm_cuda.launches == before + 1
    torch.testing.assert_close(xs.grad, xp.grad)
    torch.testing.assert_close(gs.grad, gp.grad)
