"""Port parity: the block scramble S^k (K3) and its gradient.

The plain version `scramble_blocks_torch` (what the wrapper runs on CPU
tensors) is held against the reference's `scramble_blocks_pallas` run in
interpret mode, and the differentiable `ops.scramble_blocks` against
`jax.vjp` of the reference's `ops.scramble_blocks`.  The op only moves data,
so every comparison is bitwise.  The CUDA kernel is held against the plain
version in the tests that take the `cuda` fixture (skipped without a card)
and in chip_smoke.py.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.scramble import scramble_order  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scramble as tsc  # noqa: E402
from repro_torch.kernels.ref import scramble_blocks_ref, unscramble_blocks_ref  # noqa: E402

B = 8  # block edge of the CPU cases


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels.scramble_kernel import scramble_blocks_pallas

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, pallas=scramble_blocks_pallas)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(jx, x_np, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    xj = jx.jnp.asarray(x_np, dtype=getattr(jx.jnp, dtype))
    a = np.asarray(xj)
    if dtype == "bfloat16":
        return xj, torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return xj, torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("g", [2, 3, 4, 5])
@pytest.mark.parametrize("k", [1, -1, 3, "order"])
def test_plain_matches_pallas_f32(jx, g, k):
    k = scramble_order(g) if k == "order" else k
    xj, xt = _both(jx, _x((2, g * B, g * B), seed=g), "float32")
    want = jx.pallas(xj, block_m=B, block_n=B, k=k, interpret=True)
    got = tsc.scramble_blocks_torch(xt, block_m=B, block_n=B, k=k)
    np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("g", [2, 3, 4, 5])
def test_plain_matches_pallas_bf16_leading_dims(jx, g):
    xj, xt = _both(jx, _x((2, 3, g * B, g * (B // 2)), seed=10 + g), "bfloat16")
    want = jx.pallas(xj, block_m=B, block_n=B // 2, k=-1, interpret=True)
    got = tsc.scramble_blocks(xt, block_m=B, block_n=B // 2, k=-1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jbits(want))


def test_power_equals_repeated_ref_and_order_is_identity():
    x = torch.from_numpy(_x((3 * B, 3 * B)))
    y = x
    for _ in range(3):
        y = scramble_blocks_ref(y, block_m=B, block_n=B)
    assert torch.equal(tsc.scramble_blocks(x, block_m=B, block_n=B, k=3), y)
    assert torch.equal(
        tsc.scramble_blocks(x, block_m=B, block_n=B, k=-1),
        unscramble_blocks_ref(x, block_m=B, block_n=B),
    )
    assert torch.equal(tsc.scramble_blocks(x, block_m=B, block_n=B, k=scramble_order(3)), x)


@pytest.mark.parametrize("shape", [(2 * B, 3 * B), (2 * B + 1, 2 * B), (B,)])
def test_rejects_non_square_grid(shape):
    with pytest.raises(ValueError):
        tsc.scramble_blocks(torch.zeros(shape), block_m=B, block_n=B)


@pytest.mark.parametrize("k", [1, -2, 5])
def test_gradient_matches_jax_vjp(jx, k):
    g = 4
    x_np, ct_np = _x((2, g * B, g * B), seed=1), _x((2, g * B, g * B), seed=2)
    jfun = lambda x: jx.ops.scramble_blocks(x, block_m=B, block_n=B, k=k)  # noqa: E731
    y_j, vjp = jx.jax.vjp(jfun, jx.jnp.asarray(x_np))
    (dx_j,) = vjp(jx.jnp.asarray(ct_np))

    x = torch.from_numpy(x_np).requires_grad_(True)
    y = ops.scramble_blocks(x, block_m=B, block_n=B, k=k)
    y.backward(torch.from_numpy(ct_np))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(dx_j))


# -- on the card --------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,bm,bn,dtype",
    [
        ((2, 2048, 2048), 128, 128, torch.bfloat16),  # mesh-paper's activations
        ((2, 512, 512), 128, 128, torch.float32),
        ((3, 5 * 24, 5 * 20), 24, 20, torch.bfloat16),  # 40-byte rows: byte path
        ((5 * 3, 5 * 3), 3, 3, torch.float32),  # 12-byte rows
    ],
)
@pytest.mark.parametrize("k", [1, -1, 3])
def test_cuda_kernel_matches_plain(cuda, shape, bm, bn, dtype, k):
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda).to(dtype)
    before = tsc.scramble_blocks_cuda.launches
    got = tsc.scramble_blocks(x, block_m=bm, block_n=bn, k=k)
    torch.cuda.synchronize()
    assert tsc.scramble_blocks_cuda.launches == before + 1
    assert torch.equal(got, tsc.scramble_blocks_torch(x, block_m=bm, block_n=bn, k=k))


def test_cuda_gradient_is_inverse_kernel(cuda):
    x = torch.randn(2, 1024, 1024, device=cuda, requires_grad=True)
    ct = torch.randn(2, 1024, 1024, device=cuda)
    ops.scramble_blocks(x, k=2).backward(ct)
    assert torch.equal(x.grad, tsc.scramble_blocks_torch(ct, k=-2))
