"""Port parity: the paper's mesh-array simulators and the scrambling system.

`repro_torch.core.mesh_array` and the tensor half of `repro_torch.core.scramble`
against the reference on the same numpy inputs.  On integer-valued f32
inputs every partial sum is an exact integer, so outputs and the full
per-step history are compared bitwise; on normal inputs at an f32 tolerance
of 1e-5 relative (the reference's XLA may fuse a multiply-add the port runs
as two ops).  Permutations only move data, so the scramble is bitwise.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import mesh_array as tma  # noqa: E402
from repro_torch.core import scramble as tscr  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import mesh_array, scramble

    return types.SimpleNamespace(jnp=jnp, ma=mesh_array, scr=scramble)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _ints(shape, seed, lo=-8, hi=8):
    return np.random.default_rng(seed).integers(lo, hi + 1, size=shape).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


SIMS = ["mesh-antidiagonal", "mesh-corner", "standard"]


def _simulate(mod, kind, a, b):
    if kind == "standard":
        return mod.simulate_standard(a, b, record_history=True)
    return mod.simulate_mesh(a, b, model=kind.split("-")[1], record_history=True)


@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("kind", SIMS)
def test_simulator_matches_reference(jx, kind, n):
    for inputs, exact in ((_ints, True), (_normal, False)):
        a, b = inputs((n, n), n), inputs((n, n), 100 + n)
        want = _simulate(jx.ma, kind, jx.jnp.asarray(a), jx.jnp.asarray(b))
        got = _simulate(tma, kind, torch.from_numpy(a), torch.from_numpy(b))
        assert got.steps == want.steps == (3 * n - 2 if kind == "standard" else 2 * n - 1)
        np.testing.assert_array_equal(got.completion_times, want.completion_times)
        assert got.history.shape == (got.steps, n, n)
        for g, w in ((got.output, want.output), (got.history, want.history)):
            if exact:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
        if exact:  # and the product itself, in the arrangement of each array
            c = a @ b
            out = got.output if kind == "standard" else tscr.unscramble(got.output)
            np.testing.assert_array_equal(out.numpy(), c)


@pytest.mark.parametrize("n", [3, 6, 9])
def test_start_and_completion_tables_equal(jx, n):
    for model in ("antidiagonal", "corner"):
        np.testing.assert_array_equal(tma.mesh_start_times(n, model),
                                      jx.ma.mesh_start_times(n, model))
        np.testing.assert_array_equal(tma.mesh_completion_times(n, model),
                                      jx.ma.mesh_completion_times(n, model))
    np.testing.assert_array_equal(tma.standard_start_times(n), jx.ma.standard_start_times(n))
    np.testing.assert_array_equal(tma.standard_completion_times(n),
                                  jx.ma.standard_completion_times(n))
    with pytest.raises(ValueError, match="start model"):
        tma.mesh_start_times(n, "spiral")


def test_simulator_history_off_and_integer_dtype():
    """Without record_history there is no history; int32 inputs accumulate
    in int32 (torch.result_type), exactly."""
    a = torch.from_numpy(_ints((5, 5), 1).astype(np.int32))
    b = torch.from_numpy(_ints((5, 5), 2).astype(np.int32))
    res = tma.simulate_mesh(a, b)
    assert res.history is None and res.output.dtype == torch.int32
    assert torch.equal(tscr.unscramble(res.output), a @ b)
    assert tma.simulate_mesh(torch.eye(4), torch.eye(4)).steps == 7
    assert tma.simulate_standard(torch.eye(3), torch.eye(3)).steps == 7
    with pytest.raises(ValueError, match="square"):
        tma.simulate_mesh(torch.ones(3, 4), torch.ones(4, 3))


@pytest.mark.parametrize("shape", [(6, 6), (3, 4, 4), (2, 3, 5, 5)])
def test_mesh_matmul_reference_matches(jx, shape):
    a, b = _normal(shape, 7), _normal(shape, 8)
    want = jx.ma.mesh_matmul_reference(jx.jnp.asarray(a), jx.jnp.asarray(b))
    got = tma.mesh_matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ai, bi = _ints(shape, 9), _ints(shape, 10)
    got_i = tma.mesh_matmul_reference(torch.from_numpy(ai), torch.from_numpy(bi))
    np.testing.assert_array_equal(
        got_i.numpy(),
        np.asarray(jx.ma.mesh_matmul_reference(jx.jnp.asarray(ai), jx.jnp.asarray(bi))),
    )
    if len(shape) == 2:  # the one-shot form is the simulator's output
        np.testing.assert_array_equal(
            got_i.numpy(),
            tma.simulate_mesh(torch.from_numpy(ai), torch.from_numpy(bi)).output.numpy(),
        )


# --- the scrambling system ----------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7])
@pytest.mark.parametrize("k", [-4, -1, 0, 1, 3, 25])
def test_apply_scramble_and_unscramble_bitwise(jx, n, k):
    x = _normal((2, 3, n, n), n)
    j = jx.jnp.asarray(x)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tscr.apply_scramble(t, k).numpy(),
                                  np.asarray(jx.scr.apply_scramble(j, k)))
    np.testing.assert_array_equal(tscr.unscramble(t, k).numpy(),
                                  np.asarray(jx.scr.unscramble(j, k)))
    assert torch.equal(tscr.unscramble(tscr.apply_scramble(t, k), k), t)


@pytest.mark.parametrize("n", [3, 4, 5, 8])
@pytest.mark.parametrize("k", [-5, 0, 2, 7, 200])
def test_apply_scramble_power_bitwise(jx, n, k):
    """Python-int and integer-tensor keys, against the reference's table
    gather with a traced key; and against k repeated single scrambles."""
    x = _normal((3, n, n), 50 + n)
    want = np.asarray(jx.scr.apply_scramble_power(jx.jnp.asarray(x), jx.jnp.asarray(k), n))
    t = torch.from_numpy(x)
    for key in (k, torch.tensor(k), torch.tensor([k], dtype=torch.int32)):
        np.testing.assert_array_equal(tscr.apply_scramble_power(t, key, n).numpy(), want)
    if k >= 0:
        rep = t
        for _ in range(k % tscr.scramble_order(n)):
            rep = tscr.apply_scramble(rep, 1)
        np.testing.assert_array_equal(rep.numpy(), want)


def test_apply_scramble_power_rejects_bad_keys():
    x = torch.zeros(4, 4)
    for bad in (torch.tensor(1.0), torch.tensor([1, 2])):
        with pytest.raises(ValueError, match="one integer"):
            tscr.apply_scramble_power(x, bad, 4)
    with pytest.raises(ValueError, match="trailing"):
        tscr.apply_scramble_power(x, 1, 5)
    with pytest.raises(ValueError, match="trailing"):
        tscr.apply_scramble(torch.zeros(3, 4))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32])
def test_power_perm_from_cycle_tables_equals_power_perm(n):
    base = tscr.scramble_perm(n)
    for k in (-7, -1, 0, 1, 2, 13, 10**12 + 3):
        np.testing.assert_array_equal(tscr._power_perm_np(n, k), tscr.power_perm(base, k))


@pytest.mark.parametrize("n", range(2, 17))
def test_sigma_traced_over_index_grids(jx, n):
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    wp, wq = jx.scr.sigma_traced(n, jx.jnp.asarray(i), jx.jnp.asarray(j))
    p, q = tscr.sigma_traced(n, torch.from_numpy(i), torch.from_numpy(j))
    np.testing.assert_array_equal(p.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    # and the closed form is sigma itself, 0-indexed
    table = np.asarray(tscr.sigma_table(n)) - 1
    np.testing.assert_array_equal(np.stack([p.numpy(), q.numpy()], -1), table)


@pytest.mark.parametrize("n", [2, 3, 4, 7, 10, 12])
def test_cell_lookup_block_perm_and_format_table(jx, n):
    assert tscr.format_table(n) == jx.scr.format_table(n)
    np.testing.assert_array_equal(tscr.block_scramble_perm(n), jx.scr.block_scramble_perm(n))
    for p in range(1, n + 1):
        for q in range(1, n + 1):
            assert tscr.scrambled_cell_of(n, p, q) == jx.scr.scrambled_cell_of(n, p, q)


def test_paper_scramble_orders():
    assert [tscr.scramble_order(n) for n in (3, 4, 5)] == [7, 7, 20]


# --- on the card --------------------------------------------------------------


def test_paper_claims_on_card_at_n1024(cuda):
    """The paper's step counts at n = 1024 on the card: 2n-1 and 3n-2, with
    the outputs equal to a @ b bitwise (integer-valued inputs)."""
    n = 1024
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.from_numpy(_ints((n, n), 1)).to(cuda)
        b = torch.from_numpy(_ints((n, n), 2)).to(cuda)
        c = a @ b
        mesh = tma.simulate_mesh(a, b)
        std = tma.simulate_standard(a, b)
        assert (mesh.steps, std.steps) == (2 * n - 1, 3 * n - 2)
        assert torch.equal(tscr.unscramble(mesh.output), c)
        assert torch.equal(std.output, c)
        assert torch.equal(tma.mesh_matmul_reference(a, b), mesh.output)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_apply_scramble_power_on_card_without_host_sync(cuda):
    n = 64
    x = torch.from_numpy(_normal((4, n, n), 3)).to(cuda)
    k = torch.tensor(11, device=cuda)
    want = tscr.apply_scramble_power(x.cpu(), 11, n)
    tscr.apply_scramble_power(x, k, n)  # uploads the tables once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tscr.apply_scramble_power(x, k, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), want)
