"""Port parity: the paper's symmetry claims and the symmetric early readout.

`repro_torch.core.symmetries` against `repro.core.symmetries`: the three
claim checks, the mirror cells and the readout schedule must be equal; the
readout itself is then read from the port's own simulator history and must
give the symmetric product bitwise (integer-valued inputs), within the
paper's n+1+n/2 bound, and must fail for a general product.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import mesh_array as tma  # noqa: E402
from repro_torch.core import symmetries as tsym  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    from repro.core import symmetries

    return types.SimpleNamespace(sym=symmetries)


CHECKS = ["check_row1_diagonal", "check_mirror_rows", "check_antidiagonal_structure"]


@pytest.mark.parametrize("name", CHECKS)
def test_claim_checks_equal(jx, name):
    got = [getattr(tsym, name)(n) for n in range(2, 20)]
    assert got == [getattr(jx.sym, name)(n) for n in range(2, 20)]
    assert all(got)  # the paper's claims hold at every n


@pytest.mark.parametrize("n", range(2, 33))
def test_readout_schedule_and_horizons_equal(jx, n):
    assert tsym.symmetric_readout_schedule(n) == jx.sym.symmetric_readout_schedule(n)
    got = (tsym.symmetric_readout_steps(n), tsym.paper_symmetric_bound(n),
           tsym.general_readout_steps(n))
    assert got == (jx.sym.symmetric_readout_steps(n), jx.sym.paper_symmetric_bound(n),
                   jx.sym.general_readout_steps(n))
    assert got[0] == (3 * n) // 2 <= got[1] and got[2] == 2 * n - 1


@pytest.mark.parametrize("n", [3, 6, 9])
def test_mirror_cell_equal(jx, n):
    for i in range(2, n + 1):
        for j in range(1, n + 1):
            assert tsym.mirror_cell(n, i, j) == jx.sym.mirror_cell(n, i, j)
    with pytest.raises(ValueError, match="row 1"):
        tsym.mirror_cell(n, 1, 1)


def _reads(n, a, b):
    """C and the value read for each (p, q) at the schedule's (cell, step)
    from the port simulator's history."""
    res = tma.simulate_mesh(a, b, record_history=True)
    hist = res.history.numpy()
    c = (a @ b).numpy()
    reads = {pq: (hist[t - 1, i - 1, j - 1], c[pq[0] - 1, pq[1] - 1])
             for pq, ((i, j), t) in tsym.symmetric_readout_schedule(n).items()}
    return reads


@pytest.mark.parametrize("n", [4, 8, 11, 16])
def test_symmetric_readout_reads_gram_product(n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-8, 9, size=(n, n)).astype(np.float32))
    reads = _reads(n, a, a.T.contiguous())
    assert all(got == want for got, want in reads.values())
    # a general product reads some c_qp where c_pq was wanted
    b = torch.from_numpy(rng.integers(-8, 9, size=(n, n)).astype(np.float32))
    assert any(got != want for got, want in _reads(n, a, b).values())
