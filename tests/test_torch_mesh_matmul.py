"""Port parity: the mesh GEMM (K1) and the plan/execute API.

The plain version `mesh_matmul_torch` (what the `cuda_mesh` backend runs on
CPU tensors) is held against the reference's Pallas kernels run in
interpret mode, on the same numpy inputs.  Tolerance for f32:
rtol = atol = 1e-5 — both accumulate exact f32 products in f32, but the
k-block order inside a dot and the reduction order differ.  The CUDA kernel
itself is held against the plain version in the tests marked for the card
(skipped without one) and in chip_smoke.py.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import mesh_matmul as tmm  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro.kernels.mesh_matmul import mesh_matmul_pallas, mesh_matmul_pallas_batched

    return types.SimpleNamespace(jnp=jnp, api=japi, pallas=mesh_matmul_pallas,
                                 pallas_batched=mesh_matmul_pallas_batched)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(jx, m, k, n, *, bias=False, residual=False, batch=None, **kw):
    lead = () if batch is None else (batch,)
    arrs = [_np(lead + (m, k), 0), _np(lead + (k, n), 1)]
    arrs.append(_np((n,), 2) if bias else None)
    arrs.append(_np(lead + (m, n), 3) if residual else None)
    j = [None if x is None else jx.jnp.asarray(x) for x in arrs]
    t = [None if x is None else torch.from_numpy(x) for x in arrs]
    pallas = jx.pallas if batch is None else jx.pallas_batched
    want = pallas(j[0], j[1], bias=j[2], residual=j[3], interpret=True, **kw)
    got = tmm.mesh_matmul(t[0], t[1], bias=t[2], residual=t[3], **kw)
    return got, want


SHAPES = [(8, 8, 8), (16, 24, 32), (32, 16, 8), (24, 40, 16)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("stagger", [True, False])
def test_plain_matches_pallas(jx, m, k, n, stagger):
    got, want = _run(jx, m, k, n, block_m=8, block_n=8, block_k=8, stagger=stagger)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("m,k,n,b", [(24, 16, 24, 8), (32, 48, 32, 16), (16, 8, 16, 8)])
def test_plain_scramble_out_matches_pallas(jx, m, k, n, b):
    got, want = _run(jx, m, k, n, block_m=b, block_n=b, block_k=b, scramble_out=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("activation", ["relu", "silu", "sigmoid", "tanh", "gelu", None])
def test_plain_epilogue_matches_pallas(jx, activation):
    got, want = _run(
        jx,
        16, 24, 16, bias=True, residual=True, activation=activation,
        block_m=8, block_n=8, block_k=8,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bias,residual", [(True, False), (False, True)])
def test_plain_scrambled_epilogue_follows_standard_block(jx, bias, residual):
    got, want = _run(
        jx,
        24, 16, 24, bias=bias, residual=residual, activation="gelu",
        block_m=8, block_n=8, block_k=8, scramble_out=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("scramble_out", [False, True])
def test_plain_batched_matches_pallas_batched(jx, scramble_out):
    got, want = _run(
        jx,
        16, 24, 16, bias=True, residual=True, batch=3, activation="silu",
        block_m=8, block_n=8, block_k=8, scramble_out=scramble_out,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_bf16_matches_pallas_within_one_ulp(jx):
    jnp = jx.jnp
    a, b = _np((16, 32), 4), _np((32, 16), 5)
    want = jx.pallas(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        block_m=8, block_n=8, block_k=8, interpret=True,
    )
    got = tmm.mesh_matmul(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
        block_m=8, block_n=8, block_k=8,
    )
    assert got.dtype == torch.bfloat16
    # f32 sums in different orders may round to adjacent bf16 values.
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2.0**-7, atol=1e-6
    )


def test_ragged_shapes_need_no_padding_by_caller():
    """The port's wrapper takes shapes that do not divide the blocks."""
    a, b = _np((5, 33), 6), _np((33, 70), 7)
    got = tmm.mesh_matmul(torch.from_numpy(a), torch.from_numpy(b), block_m=8,
                          block_n=16, block_k=8)
    np.testing.assert_allclose(got.numpy(), a @ b, **F32)


def test_row_results_do_not_depend_on_row_count():
    """A row's result is bitwise the same at M=1 and M=4 (one M block), the
    property paged decode relies on to equal dense decode."""
    a, b = torch.from_numpy(_np((4, 64), 8)), torch.from_numpy(_np((64, 48), 9))
    full = tmm.mesh_matmul(a, b, block_m=16, block_n=16, block_k=16)
    one = tmm.mesh_matmul(a[2:3], b, block_m=16, block_n=16, block_k=16)
    assert torch.equal(full[2:3], one)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(scramble_out=True, block_m=8, block_n=4), "square block grid"),
        (dict(scramble_out=True, block_m=5), "block-aligned"),
        (dict(activation="swish"), "activation must be one of"),
    ],
)
def test_wrapper_rejects_bad_arguments(kw, match):
    a = torch.zeros(16, 8)
    with pytest.raises(ValueError, match=match):
        tmm.mesh_matmul(a, torch.zeros(8, 16), **kw)


def test_wrapper_rejects_contraction_mismatch():
    with pytest.raises(ValueError, match="contraction mismatch"):
        tmm.mesh_matmul(torch.zeros(4, 8), torch.zeros(9, 4))


# -- plan/execute API ----------------------------------------------------------


def _api_case(kind):
    """(a, b, bias, residual, spec kwargs) numpy inputs for one spec kind."""
    if kind == "general":
        return _np((16, 24), 0), _np((24, 16), 1), None, None, {}
    if kind == "folded":
        return _np((2, 8, 24), 0), _np((24, 16), 1), None, None, {}
    if kind == "batched_b":
        return _np((3, 8, 16), 0), _np((3, 16, 24), 1), None, _np((3, 8, 24), 3), {}
    if kind == "scrambled":
        return _np((24, 16), 0), _np((16, 24), 1), None, None, {"structure": "scrambled"}
    if kind == "epilogue":
        return _np((16, 24), 0), _np((24, 32), 1), _np((32,), 2), _np((16, 32), 3), {}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["general", "folded", "batched_b", "scrambled", "epilogue"])
def test_cuda_mesh_plan_on_cpu_matches_pallas_mesh_plan(jx, kind):
    jnp, japi = jx.jnp, jx.api
    a, b, bias, res, kw = _api_case(kind)
    act = "gelu" if kind == "epilogue" else None
    jspec = japi.GemmSpec.from_operands(
        jnp.asarray(a), jnp.asarray(b), blocks=(8, 8, 8),
        epilogue=japi.Epilogue(bias=bias is not None, activation=act, residual=res is not None),
        **kw,
    )
    want = japi.plan(jspec, backend="pallas_mesh", fallback=False)(
        jnp.asarray(a), jnp.asarray(b),
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res),
    )
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tspec = api.GemmSpec.from_operands(
        ta, tb, blocks=(8, 8, 8),
        epilogue=api.Epilogue(bias=bias is not None, activation=act, residual=res is not None),
        **kw,
    )
    p = api.plan(tspec, backend="cuda_mesh", device="cpu")
    got = p(ta, tb,
            bias=None if bias is None else torch.from_numpy(bias),
            residual=None if res is None else torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the other backends agree with the kernel's contract too
    other = api.plan(tspec, backend="ref", device="cpu")(
        ta, tb, bias=None if bias is None else torch.from_numpy(bias),
        residual=None if res is None else torch.from_numpy(res))
    np.testing.assert_allclose(other.numpy(), np.asarray(want), **F32)


def test_plan_is_cached_per_spec_backend_and_device():
    api.clear_plan_cache()
    a, b = torch.zeros(8, 16), torch.zeros(16, 8)
    spec = api.GemmSpec.from_operands(a, b)
    p1 = api.plan(spec, backend="cuda_mesh", device="cpu")
    p2 = api.plan(spec, backend="cuda_mesh", device="cpu")
    p3 = api.plan(spec, backend="torch", device="cpu")
    assert p1 is p2 and p1 is not p3
    info = api.plan_cache_info()
    assert (info["size"], info["hits"], info["misses"]) == (2, 1, 2)
    assert info["plans"][0]["blocks"] == [128, 128, 128]  # the default blocks
    assert info["plans"][0]["device"] == "cpu"


def test_auto_choice_and_capability_errors():
    a = torch.zeros(16, 16)
    assert api.plan(api.GemmSpec.from_operands(a, a), device="cpu").backend == "torch"
    scr = api.GemmSpec.from_operands(a, a, structure="scrambled", blocks=(8, 8, 8))
    assert api.plan(scr, device="cpu").backend == "cuda_mesh"
    with pytest.raises(api.CapabilityError, match="does not support structure"):
        api.plan(scr, backend="torch", device="cpu")


def test_spec_validation_errors():
    with pytest.raises(api.PlanValidationError, match="block-aligned"):
        api.plan(api.GemmSpec(m=12, k=8, n=16, structure="scrambled", blocks=(8, 8, 8)),
                 backend="cuda_mesh")
    with pytest.raises(api.PlanValidationError, match="square block grid"):
        api.plan(api.GemmSpec(m=8, k=8, n=16, structure="scrambled", blocks=(8, 8, 8)),
                 backend="cuda_mesh")
    with pytest.raises(api.PlanValidationError, match="square product"):
        api.plan(api.GemmSpec(m=8, k=8, n=16, structure="symmetric"), backend="torch")
    with pytest.raises(ValueError, match="structure must be"):
        api.GemmSpec(m=8, k=8, n=8, structure="diagonal")
    with pytest.raises(ValueError, match="batched_b requires"):
        api.GemmSpec(m=8, k=8, n=8, batched_b=True)


def test_plan_checks_operands():
    a, b = torch.zeros(8, 16), torch.zeros(16, 8)
    p = api.plan(api.GemmSpec.from_operands(a, b), backend="cuda_mesh", device="cpu")
    with pytest.raises(ValueError, match="do not match plan spec"):
        p(torch.zeros(9, 16), b)
    with pytest.raises(ValueError, match="dtypes"):
        p(a.double(), b.double())
    with pytest.raises(ValueError, match="built without bias"):
        p(a, b, bias=torch.zeros(8))


def test_register_backend_rules():
    with pytest.raises(ValueError, match="unknown capabilities"):
        api.register_backend("x", lambda *a: None, {"warp_speed": True})
    with pytest.raises(ValueError, match="already registered"):
        api.register_backend("torch", lambda *a: None, {})
    api.register_backend("double", lambda p, a, b, bias, r: 2 * (a @ b), {})
    try:
        a = torch.ones(4, 4)
        p = api.plan(api.GemmSpec.from_operands(a, a), backend="double", device="cpu")
        assert torch.equal(p(a, a), torch.full((4, 4), 8.0))
    finally:
        api.unregister_backend("double")
    assert "double" not in api.backend_names()


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n,kw",
    [
        (4, 256, 384, {}),
        (40, 96, 72, dict(stagger=False, block_m=16, block_n=16, block_k=32)),
        (32, 64, 32, dict(scramble_out=True, block_m=8, block_n=8, block_k=16, activation="gelu")),
    ],
)
def test_kernel_matches_plain_on_card(cuda, m, k, n, kw):
    a = torch.from_numpy(_np((m, k), 0)).to(cuda)
    b = torch.from_numpy(_np((k, n), 1)).to(cuda)
    res = torch.from_numpy(_np((m, n), 2)).to(cuda)
    before = tmm.mesh_matmul.launches
    got = tmm.mesh_matmul(a, b, residual=res, **kw)
    want = tmm.mesh_matmul_torch(a, b, residual=res, **kw)
    torch.cuda.synchronize()
    assert tmm.mesh_matmul.launches == before + 1
    # f32: only the summation order differs from the plain version (TF32
    # would be off by ~1e-4 of the largest value).
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_batched_kernel_matches_plain_on_card(cuda):
    a = torch.from_numpy(_np((3, 24, 40), 0)).to(cuda).bfloat16()
    b = torch.from_numpy(_np((3, 40, 56), 1)).to(cuda).bfloat16()
    got = tmm.mesh_matmul(a, b, block_m=16, block_n=16, block_k=16)
    want = tmm.mesh_matmul_torch(a, b, block_m=16, block_n=16, block_k=16)
    # bf16 output: the two f32 sums may round to adjacent bf16 values.
    assert (got.float() - want.float()).abs().max().item() <= 2.0**-7 * want.float().abs().max().item()


@pytest.mark.parametrize(
    "m,k,n,dtype,kw,tile",
    [
        (200, 2008, 200, "bfloat16", {}, "tc128"),  # ragged M, N and K
        (17, 512, 384, "bfloat16", dict(activation="gelu", bias=True), "tc128"),
        (4, 2008, 1000, "bfloat16", dict(bias=True), "tc_decode"),
        (16, 256, 8192, "bfloat16", {}, "tc_decode"),
        (8, 512, 256, "bfloat16", dict(block_n=16), "tc_decode"),  # blocks under the tile
        (512, 256, 512, "bfloat16", dict(scramble_out=True, activation="gelu", bias=True),
         "tc128"),
        (512, 256, 512, "float32", dict(scramble_out=True, activation="silu", bias=True),
         "f32_128"),
        (200, 2004, 196, "float32", {}, "f32_128"),
    ],
)
def test_new_tiles_match_plain_on_card(cuda, m, k, n, dtype, kw, tile):
    dt = getattr(torch, dtype)
    kw = dict(kw)
    a = torch.from_numpy(_np((m, k), 0)).to(cuda, dt)
    b = torch.from_numpy(_np((k, n), 1)).to(cuda, dt)
    if kw.pop("bias", False):
        kw["bias"] = torch.from_numpy(_np((n,), 3)).to(cuda, dt)
    res = torch.from_numpy(_np((m, n), 2)).to(cuda, dt)
    before = dict(tmm.mesh_matmul.launches_by_config)
    got = tmm.mesh_matmul(a, b, residual=res, **kw)
    want = tmm.mesh_matmul_torch(a, b, residual=res, **kw)
    torch.cuda.synchronize()
    assert tmm.mesh_matmul.launches_by_config.get(tile, 0) == before.get(tile, 0) + 1
    # f32: summation order only; bf16 output: adjacent roundings.
    tol = (1e-5 if dt == torch.float32 else 2.0**-7) * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_batched_tensor_core_tile_matches_plain_on_card(cuda):
    a = torch.from_numpy(_np((3, 128, 256), 0)).to(cuda).bfloat16()
    b = torch.from_numpy(_np((3, 256, 384), 1)).to(cuda).bfloat16()
    before = tmm.mesh_matmul.launches_by_config.get("tc128", 0)
    got = tmm.mesh_matmul(a, b)
    want = tmm.mesh_matmul_torch(a, b)
    torch.cuda.synchronize()
    assert tmm.mesh_matmul.launches_by_config.get("tc128", 0) == before + 1
    assert (got.float() - want.float()).abs().max().item() <= 2.0**-7 * want.float().abs().max().item()
