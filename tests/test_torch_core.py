"""Port parity: sigma tables, S^k and the block-scramble oracles.

The numpy tables of `repro_torch.core.scramble` must equal the reference's
exactly, and the torch oracles of `repro_torch.kernels.ref` must move the
same data (bitwise on integer-valued f32 inputs, where every f32 sum is
exact in any order).
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import scramble as tscr  # noqa: E402
from repro_torch.kernels import mesh_matmul as tmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import scramble
    from repro.kernels import mesh_matmul, ref

    return types.SimpleNamespace(jnp=jnp, scr=scramble, mm=mesh_matmul, ref=ref)


NS = [3, 4, 5, 6, 7]


@pytest.mark.parametrize("n", NS)
def test_sigma_tables_equal(jx, n):
    assert tscr.sigma_table(n) == jx.scr.sigma_table(n)
    np.testing.assert_array_equal(tscr.scramble_perm(n), jx.scr.scramble_perm(n))
    assert tscr.cycle_decomposition(n) == jx.scr.cycle_decomposition(n)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", [-3, -1, 0, 1, 2, 9])
def test_power_perm_equal(jx, n, k):
    perm = jx.scr.scramble_perm(n)
    np.testing.assert_array_equal(tscr.power_perm(perm, k), jx.scr.power_perm(perm, k))
    np.testing.assert_array_equal(tscr.inverse_perm(perm), jx.scr.inverse_perm(perm))


@pytest.mark.parametrize("n,order", [(3, 7), (4, 7), (5, 20)])
def test_scramble_order_matches_paper(jx, n, order):
    assert tscr.scramble_order(n) == order == jx.scr.scramble_order(n)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 6])
def test_sigma_block_table_equal(jx, g):
    t = tmm.sigma_block_table(g)
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t, jx.mm.sigma_block_table(g))


def test_sigma_rejects_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        tscr.sigma(3, 0, 1)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-4, 5, size=shape).astype(np.float32)


@pytest.mark.parametrize("lead,g,bm,bn", [((), 3, 4, 8), ((2,), 4, 2, 2), ((2, 3), 2, 8, 4)])
def test_scramble_blocks_ref_bitwise(jx, lead, g, bm, bn):
    x = _ints(lead + (g * bm, g * bn), 0)
    got = tref.scramble_blocks_ref(torch.from_numpy(x), block_m=bm, block_n=bn)
    want = jx.ref.scramble_blocks_ref(jx.jnp.asarray(x), block_m=bm, block_n=bn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tref.unscramble_blocks_ref(got, block_m=bm, block_n=bn)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jx.ref.unscramble_blocks_ref(want, block_m=bm, block_n=bn)),
    )


def test_scramble_blocks_ref_rejects_non_square_grid():
    with pytest.raises(ValueError, match="square grid"):
        tref.scramble_blocks_ref(torch.zeros(8, 12), block_m=4, block_n=4)


@pytest.mark.parametrize("m,k,n,bm,bn", [(12, 8, 12, 4, 4), (16, 24, 32, 8, 16)])
def test_matmul_and_mesh_matmul_ref_bitwise(jx, m, k, n, bm, bn):
    a, b = _ints((m, k), 1), _ints((k, n), 2)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jx.jnp.asarray(a), jx.jnp.asarray(b)
    np.testing.assert_array_equal(
        tref.matmul_ref(at, bt).numpy(), np.asarray(jx.ref.matmul_ref(ja, jb))
    )
    np.testing.assert_array_equal(
        tref.mesh_matmul_ref(at, bt, block_m=bm, block_n=bn).numpy(),
        np.asarray(jx.ref.mesh_matmul_ref(ja, jb, block_m=bm, block_n=bn)),
    )


def test_matmul_ref_accumulates_bf16_in_f32():
    """bf16 operands: exact products, f32 sums, one rounding at the end."""
    a = torch.full((1, 256), 1.0 + 2.0**-7, dtype=torch.bfloat16)
    b = torch.ones(256, 1, dtype=torch.bfloat16)
    assert tref.matmul_ref(a, b, torch.float32).item() == 256 * (1.0 + 2.0**-7)
