"""Port parity: the grouped (ragged-batch) mesh GEMM K5 and its planner.

The plain version `grouped_mesh_matmul_torch` (what the `cuda_mesh` grouped
backend runs on CPU tensors) is held against the reference's Pallas kernel
`grouped_mesh_matmul_pallas` run in interpret mode and against its oracle
`grouped_matmul_ref`, on the same numpy inputs.  Tolerance for f32:
rtol = atol = 1e-5 — both accumulate exact f32 products in f32, but the
k-block order inside a dot and the reduction order differ.  Gradients of
`_GroupedMM` are held against `jax.grad` through the reference's
`pallas_mesh` grouped plan within 1e-5·max|ref| (the reference's own VJP
reads up to 4.4e-6 apart from autodiff on values of about 93).  The CUDA
kernel itself is held against the plain version in the test that needs the
card (skipped without one) and in chip_smoke.py.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import grouped as tg  # noqa: E402
from repro_torch.kernels.ref import grouped_matmul_ref  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it (the GPU machine
    runs these files without JAX: there only the port-alone tests run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro.kernels.grouped import grouped_mesh_matmul_pallas
    from repro.kernels.ref import grouped_matmul_ref as jref

    return types.SimpleNamespace(jax=jax, jnp=jnp, api=japi, pallas=grouped_mesh_matmul_pallas,
                                 ref=jref)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.clear_plan_cache()
    yield
    api.clear_plan_cache()


def _case(g=4, rpg=16, k=24, n=20, seed=0, sizes=None, pad_value=0.0):
    """Capacity-layout tokens (padding rows hold `pad_value`), sizes,
    offsets and stacked weights, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(g * rpg, k)).astype(np.float32)
    w = rng.normal(size=(g, k, n)).astype(np.float32)
    if sizes is None:
        sizes = rng.integers(0, rpg + 1, size=g)
    sizes = np.asarray(sizes, np.int32)
    valid = (np.arange(rpg)[None, :] < sizes[:, None]).reshape(-1, 1)
    tokens = np.where(valid, tokens, np.float32(pad_value))
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return tokens, sizes, off, w


def _t(*arrs):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrs]


def _epilogue(g, rpg, n, seed, bias, residual):
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(g, n)).astype(np.float32) if bias else None
    r = rng.normal(size=(g * rpg, n)).astype(np.float32) if residual else None
    return b, r


# -- the plain version against the Pallas kernel and the oracle ---------------

KERNEL_CASES = [
    # (g, rpg, k, n, sizes, blocks (bm, bn, bk), stagger)
    (4, 16, 32, 16, None, (8, 8, 8), True),
    (4, 16, 32, 16, None, (8, 8, 8), False),
    (3, 8, 48, 24, [8, 0, 5], (8, 8, 16), True),
    (2, 32, 16, 32, [32, 17], (16, 16, 8), True),
    (1, 32, 24, 16, [20], (8, 8, 8), True),  # single group
    (4, 8, 16, 8, [0, 0, 0, 0], (8, 8, 8), True),  # every group empty
]


@pytest.mark.parametrize("g,rpg,k,n,sizes,blocks,stagger", KERNEL_CASES)
def test_plain_matches_pallas(jx, g, rpg, k, n, sizes, blocks, stagger):
    tokens, sz, _, w = _case(g, rpg, k, n, seed=g + rpg, sizes=sizes)
    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk, stagger=stagger)
    want = jx.pallas(jx.jnp.asarray(tokens), jx.jnp.asarray(sz), jx.jnp.asarray(w),
                     interpret=True, **kw)
    got = tg.grouped_mesh_matmul(*_t(tokens, sz, w), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ref = jx.ref(jx.jnp.asarray(tokens), jx.jnp.asarray(sz), jx.jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("activation", ["relu", "silu", "sigmoid", "tanh", "gelu", None])
def test_plain_epilogue_matches_pallas(jx, activation):
    g, rpg, k, n = 4, 16, 32, 16
    tokens, sz, _, w = _case(g, rpg, k, n, seed=1)
    b, r = _epilogue(g, rpg, n, 2, bias=True, residual=True)
    kw = dict(block_m=8, block_n=8, block_k=8, activation=activation)
    j = [jx.jnp.asarray(a) for a in (tokens, sz, w, b, r)]
    want = jx.pallas(j[0], j[1], j[2], bias=j[3], residual=j[4], interpret=True, **kw)
    t = _t(tokens, sz, w, b, r)
    got = tg.grouped_mesh_matmul(t[0], t[1], t[2], bias=t[3], residual=t[4], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("k,n,blocks", [(20, 12, (8, 8, 8)), (40, 24, (8, 16, 16))])
def test_plain_ragged_k_n_matches_oracle(jx, k, n, blocks):
    """K and N that do not divide their blocks: padded in the plain version
    (masked in the kernel), as the reference's `_gmm_impl` pads them."""
    tokens, sz, off, w = _case(3, 16, k, n, seed=k)
    bm, bn, bk = blocks
    got = tg.grouped_mesh_matmul(*_t(tokens, sz, w), block_m=bm, block_n=bn, block_k=bk)
    want = jx.ref(jx.jnp.asarray(tokens), jx.jnp.asarray(sz), jx.jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("pad_value", [0.0, 7.0, np.nan, np.inf])
def test_rows_past_size_are_exact_zeros(pad_value):
    """Whatever the padding rows hold, rows at or past a group's size come
    back as exact zeros, epilogue included, and valid rows are unaffected."""
    g, rpg, k, n = 3, 16, 24, 16
    tokens, sz, _, w = _case(g, rpg, k, n, seed=3, sizes=[16, 5, 0], pad_value=pad_value)
    b, r = _epilogue(g, rpg, n, 4, bias=True, residual=True)
    t = _t(tokens, sz, w, b, r)
    out = tg.grouped_mesh_matmul(t[0], t[1], t[2], bias=t[3], residual=t[4], block_m=8,
                                 block_n=8, block_k=8, activation="silu").numpy()
    valid = (np.arange(rpg)[None, :] < sz[:, None]).reshape(-1)
    assert np.all(out[~valid] == 0.0)
    clean, _, _, _ = _case(g, rpg, k, n, seed=3, sizes=[16, 5, 0])
    want = tg.grouped_mesh_matmul(torch.from_numpy(clean), t[1], t[2], bias=t[3],
                                  residual=t[4], block_m=8, block_n=8, block_k=8,
                                  activation="silu").numpy()
    np.testing.assert_array_equal(out, want)


def test_port_oracle_matches_reference_oracle(jx):
    tokens, sz, _, w = _case(seed=5, sizes=[16, 0, 3, 9])
    got = grouped_matmul_ref(*_t(tokens, sz, w))
    want = jx.ref(jx.jnp.asarray(tokens), jx.jnp.asarray(sz), jx.jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the planner ---------------------------------------------------------------

BACKEND_PAIRS = [("torch", "xla"), ("ref", "ref"), ("cuda_mesh", "pallas_mesh")]


@pytest.mark.parametrize("ours,theirs", BACKEND_PAIRS)
@pytest.mark.parametrize("sizes", [None, [0, 0, 0, 0], [16, 0, 3, 0]])
def test_grouped_plan_matches_reference_plan(jx, ours, theirs, sizes):
    tokens, sz, off, w = _case(sizes=sizes, seed=6)
    want = jx.api.plan(jx.api.GemmSpec.for_groups(jx.api.GroupSpec(4, 16), 24, 20),
                       backend=theirs)(*[jx.jnp.asarray(a) for a in (tokens, off, w)])
    p = api.plan(api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20), backend=ours)
    assert isinstance(p, api.GroupedPlan)
    got = p(*_t(tokens, off, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if sizes == [0, 0, 0, 0]:
        assert not got.any()


@pytest.mark.parametrize("ours,theirs", BACKEND_PAIRS)
def test_grouped_plan_epilogue_matches_reference_plan(jx, ours, theirs):
    tokens, sz, off, w = _case(seed=7)
    b, r = _epilogue(4, 16, 20, 8, bias=True, residual=True)
    epi = dict(bias=True, activation="gelu", residual=True)
    jspec = jx.api.GemmSpec.for_groups(jx.api.GroupSpec(4, 16), 24, 20,
                                       epilogue=jx.api.Epilogue(**epi))
    j = [jx.jnp.asarray(a) for a in (tokens, off, w, b, r)]
    want = jx.api.plan(jspec, backend=theirs)(j[0], j[1], j[2], bias=j[3], residual=j[4])
    spec = api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20, epilogue=api.Epilogue(**epi))
    t = _t(tokens, off, w, b, r)
    got = api.plan(spec, backend=ours)(t[0], t[1], t[2], bias=t[3], residual=t[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_block_m_clamped_to_divide_rows_per_group(jx):
    """rpg = 24 with the default block_m of 128: the plan clamps block_m to
    gcd(24, 128) = 8, so whole row blocks tile each group."""
    p = api.plan(api.GemmSpec.for_groups(api.GroupSpec(4, 24), 32, 32), backend="cuda_mesh")
    assert p.blocks == (8, 128, 128) and 24 % p.blocks[0] == 0
    assert api._grouped_block_m(160, 128) == 32 and api._grouped_block_m(12, 128) == 12
    tokens, sz, off, w = _case(g=4, rpg=24, k=32, n=32, sizes=[24, 5, 0, 17])
    got = p(*_t(tokens, off, w))
    want = jx.ref(jx.jnp.asarray(tokens), jx.jnp.asarray(sz), jx.jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_one_plan_per_group_spec():
    spec_a = api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20)
    spec_b = api.GemmSpec.for_groups(api.GroupSpec(8, 8), 24, 20)  # same m!
    assert spec_a.m == spec_b.m
    p_a = api.plan(spec_a, backend="cuda_mesh")
    p_b = api.plan(spec_b, backend="cuda_mesh")
    assert p_a is not p_b  # the GroupSpec is part of the cache key
    assert api.plan(spec_a, backend="cuda_mesh") is p_a
    info = api.plan_cache_info()
    assert info["size"] == 2 and info["hits"] == 1 and info["misses"] == 2
    assert all(p["grouped"] for p in info["plans"])
    assert info["plans"][0]["grouped"]["per_group_flops"] == 2 * 16 * 24 * 20


def test_grouped_capability_rejection():
    """Backends that do not declare `grouped` reject grouped specs; declaring
    it without a grouped_impl is rejected at registration."""
    api.register_backend("nogrouped_double", lambda p, a, b, bias, res: a @ b,
                         {"structures": {"general"}})
    try:
        spec = api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20)
        with pytest.raises(api.CapabilityError, match="grouped"):
            api.plan(spec, backend="nogrouped_double")
        with pytest.raises(ValueError, match="grouped_impl"):
            api.register_backend("half_grouped", lambda p, a, b, bias, res: a @ b,
                                 {"structures": {"general"}, "grouped": True})
    finally:
        api.unregister_backend("nogrouped_double")
    assert "half_grouped" not in api.backend_names()


def test_grouped_spec_validation():
    with pytest.raises(ValueError, match="for_groups"):
        api.GemmSpec(m=65, k=24, n=20, group=api.GroupSpec(4, 16))
    with pytest.raises(ValueError, match="general"):
        api.GemmSpec(m=64, k=24, n=20, group=api.GroupSpec(4, 16), structure="scrambled")
    with pytest.raises(ValueError, match="batch"):
        api.GemmSpec(m=64, k=24, n=20, group=api.GroupSpec(4, 16), batch=(2,))
    with pytest.raises(ValueError, match="positive"):
        api.GroupSpec(0, 16)
    with pytest.raises(TypeError, match="GroupSpec"):
        api.GemmSpec(m=64, k=24, n=20, group=(4, 16))


def test_grouped_operand_validation():
    tokens, sz, off, w = _t(*_case())
    p = api.plan(api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20), backend="cuda_mesh")
    with pytest.raises(ValueError, match="group_offsets"):
        p(tokens, off[:-1], w)
    with pytest.raises(ValueError, match="integer"):
        p(tokens, off.float(), w)
    with pytest.raises(ValueError, match="do not match"):
        p(tokens[:, :-1], off, w)
    with pytest.raises(ValueError, match="without bias"):
        p(tokens, off, w, bias=torch.zeros(4, 20))
    with pytest.raises(ValueError, match="dtypes"):
        p(tokens.double(), off, w)
    pe = api.plan(api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20,
                                          epilogue=api.Epilogue(bias=True)))
    with pytest.raises(ValueError, match=r"grouped bias must have shape \(4, 20\)"):
        pe(tokens, off, w, bias=torch.zeros(20))


def test_kernel_wrapper_validation():
    tokens, sz, _, w = _t(*_case())
    with pytest.raises(ValueError, match="block_m"):
        tg.grouped_mesh_matmul(tokens, sz, w, block_m=32, block_n=8, block_k=8)
    with pytest.raises(ValueError, match="divisible by num_groups"):
        tg.grouped_mesh_matmul(tokens[:-1], sz, w, block_m=1)
    with pytest.raises(ValueError, match="sizes"):
        tg.grouped_mesh_matmul(tokens, sz.float(), w, block_m=8)
    with pytest.raises(ValueError, match="activation"):
        tg.grouped_mesh_matmul(tokens, sz, w, block_m=8, activation="swish")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tg.grouped_mesh_matmul(tokens.to("meta"), sz, w, block_m=8)


# -- gradients -------------------------------------------------------------------


@pytest.mark.parametrize("epi", [{}, dict(bias=True, activation="gelu", residual=True),
                                 dict(activation="silu")])
def test_grouped_grads_match_reference_vjp(jx, epi):
    """`_GroupedMM` (the `_gmm` VJP on the plain K5) against jax.grad through
    the reference's pallas_mesh grouped plan, for every operand."""
    jnp = jx.jnp
    g, rpg, k, n = 4, 16, 24, 20
    tokens, sz, off, w = _case(g, rpg, k, n, seed=5)
    b, r = _epilogue(g, rpg, n, 9, bias=epi.get("bias", False),
                     residual=epi.get("residual", False))
    jspec = jx.api.GemmSpec.for_groups(jx.api.GroupSpec(g, rpg), k, n,
                                       epilogue=jx.api.Epilogue(**epi))
    jp = jx.api.plan(jspec, backend="pallas_mesh")
    names = ["tokens", "w"] + (["bias"] if b is not None else []) + (
        ["residual"] if r is not None else [])
    vals = {"tokens": tokens, "w": w, "bias": b, "residual": r}

    def jloss(*args):
        kw = dict(zip(names, args))
        out = jp(kw["tokens"], jnp.asarray(off), kw["w"], bias=kw.get("bias"),
                 residual=kw.get("residual"))
        return jnp.sum(out**2)

    want = jx.jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(vals[nm]) for nm in names])

    spec = api.GemmSpec.for_groups(api.GroupSpec(g, rpg), k, n, epilogue=api.Epilogue(**epi))
    p = api.plan(spec, backend="cuda_mesh")
    leaves = {nm: torch.from_numpy(vals[nm]).requires_grad_(True) for nm in names}
    out = p(leaves["tokens"], torch.from_numpy(off), leaves["w"], bias=leaves.get("bias"),
            residual=leaves.get("residual"))
    assert type(out.grad_fn).__name__ == "_GroupedMMBackward"
    (out**2).sum().backward()
    for nm, ref_grad in zip(names, want):
        ref_grad = np.asarray(ref_grad)
        got = leaves[nm].grad.numpy()
        tol = 1e-5 * np.abs(ref_grad).max()
        np.testing.assert_allclose(got, ref_grad, rtol=0, atol=tol, err_msg=nm)


def test_grouped_grads_match_autograd_through_oracle():
    """The same VJP against plain autograd through the port's oracle."""
    tokens, sz, off, w = _t(*_case(seed=11))
    t1, w1 = tokens.clone().requires_grad_(True), w.clone().requires_grad_(True)
    t2, w2 = tokens.clone().requires_grad_(True), w.clone().requires_grad_(True)
    p = api.plan(api.GemmSpec.for_groups(api.GroupSpec(4, 16), 24, 20), backend="cuda_mesh")
    (p(t1, off, w1) ** 2).sum().backward()
    (grouped_matmul_ref(t2, sz, w2) ** 2).sum().backward()
    for got, ref_grad in ((t1.grad, t2.grad), (w1.grad, w2.grad)):
        tol = 1e-5 * ref_grad.abs().max().item()
        torch.testing.assert_close(got, ref_grad, rtol=0, atol=tol)


# -- the kernel on the card ------------------------------------------------------


@pytest.mark.parametrize("rpg,k,n,bm,dtype,epi", [
    (8, 256, 512, 8, torch.bfloat16, {}),
    (128, 256, 192, 128, torch.bfloat16, {}),
    (24, 100, 72, 8, torch.float32, dict(bias=True, residual=True, activation="silu")),
])
def test_kernel_matches_plain_on_card(cuda, rpg, k, n, bm, dtype, epi):
    g = 6
    tokens, sz, _, w = _case(g, rpg, k, n, seed=rpg, sizes=[0, rpg, 1, rpg // 2, 3, 0])
    b, r = _epilogue(g, rpg, n, 12, bias=epi.get("bias", False),
                     residual=epi.get("residual", False))
    t = [None if a is None else a.to(cuda, dtype) for a in _t(tokens, sz, w, b, r)]
    t[1] = torch.from_numpy(sz).to(cuda)
    kw = dict(block_m=bm, block_n=128, block_k=128, activation=epi.get("activation"))
    before = tg.grouped_mesh_matmul.launches
    out = tg.grouped_mesh_matmul(t[0], t[1], t[2], bias=t[3], residual=t[4], **kw)
    ref = tg.grouped_mesh_matmul_torch(t[0], t[1], t[2], bias=t[3], residual=t[4], **kw)
    torch.cuda.synchronize()
    assert tg.grouped_mesh_matmul.launches == before + 1
    valid = (np.arange(rpg)[None, :] < sz[:, None]).reshape(-1)
    assert not out[torch.from_numpy(~valid).to(cuda)].any()
    scale = (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= scale


# -- the tile choice (no card needed) --------------------------------------------


def _olmoe_grouped_shapes():
    """(rows per group, K, N) of every grouped GEMM OLMoE-1B-7B's serving path
    gives K5 at chip_smoke.py's shapes (a decode step of 4 tokens and a
    128-token prefill), as `moe_block` sizes them: wi (d_model -> 2 x expert
    d_ff) and wo (expert d_ff -> d_model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    e, top, d, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model, cfg.moe_d_ff
    out = []
    for n, t in ((4, 1), (128, 128)):
        cap = moe._capacity(n, t, e, top, 1.25)
        rpg = -(-cap // moe._ROW_ALIGN) * moe._ROW_ALIGN
        out += [(rpg, d, 2 * f), (rpg, f, d)]
    return out


def _plan_blocks(rpg, k, n):
    """The blocks the planner gives K5 at (rpg, K, N) on the CPU (the
    reference's; on the card the autotuner picks among candidates that take
    a tensor-core tile)."""
    spec = api.GemmSpec.for_groups(api.GroupSpec(64, rpg), k, n, dtype_a="bfloat16",
                                   dtype_b="bfloat16")
    return api.plan(spec, backend="cuda_mesh", device="cpu").blocks


def test_olmoe_serving_shapes_take_tensor_core_tiles():
    shapes = _olmoe_grouped_shapes()
    assert [s[0] for s in shapes] == [8, 8, 128, 128]  # decode 8/8, prefill 128/128
    for rpg, k, n in shapes:
        bm, bn, bk = _plan_blocks(rpg, k, n)
        want = "tc_decode" if rpg == 8 else "tc_rows32"
        assert bm == rpg, (rpg, bm)
        assert tg.tile_config(n, k, bm, bn, bk, torch.bfloat16) == want, (rpg, k, n)


@pytest.mark.parametrize("activation", [None, "silu"])
def test_gmm_backward_f32_products_take_the_simt_tiles(activation):
    """Every grouped GEMM `gmm_backward` runs (z remat, dtokens) at OLMoE's
    serving shapes, recorded on meta tensors, is f32 and takes a SIMT tile:
    the decode one for 8-row blocks, the 64x64 one for 128-row blocks."""
    calls = []

    def record(tokens, sizes, w, **kw):
        calls.append((tokens.shape[0] // w.shape[0], w.shape[1], w.shape[2], kw,
                      tokens.dtype, w.dtype))
        return torch.empty(tokens.shape[0], w.shape[2], dtype=kw["out_dtype"],
                           device=tokens.device)

    for rpg, k, n in _olmoe_grouped_shapes():
        g = 64
        bm, bn, bk = _plan_blocks(rpg, k, n)
        meta = dict(dtype=torch.bfloat16, device="meta")
        tokens, w = torch.empty(g * rpg, k, **meta), torch.empty(g, k, n, **meta)
        sizes = torch.empty(g, dtype=torch.int32, device="meta")
        opts = api.MMOpts(bm, bn, bk, True, False, torch.bfloat16, activation)
        api.gmm_backward(torch.empty(g * rpg, n, **meta), tokens, sizes, w, None, None, opts,
                         matmul=record)
    assert len(calls) == 4 * (2 if activation else 1)
    for rpg, kk, nn, kw, dt, dw in calls:
        assert dt == dw == torch.float32
        tile = tg.tile_config(nn, kk, kw["block_m"], kw["block_n"], kw["block_k"], dt)
        assert tile == ("simt_decode" if rpg == 8 else "simt64"), (rpg, kk, nn, kw)


@pytest.mark.parametrize(
    "n,k,blocks,dtype,want",
    [
        (2048, 2048, (8, 128, 128), torch.bfloat16, "tc_decode"),
        (2048, 1024, (16, 128, 128), torch.bfloat16, "tc_decode"),
        (2048, 2048, (128, 128, 128), torch.bfloat16, "tc_rows32"),
        (360, 1000, (24, 128, 128), torch.bfloat16, "tc_rows32"),  # ragged N and K
        (2044, 2048, (128, 128, 128), torch.bfloat16, "simt64"),  # N not in 16-byte rows
        (2048, 2048, (128, 128, 16), torch.bfloat16, "simt64"),  # k block under the k step
        (2048, 2048, (128, 32, 128), torch.bfloat16, "simt64"),  # blocks under 64 wide
        (2048, 2048, (8, 8, 128), torch.bfloat16, "simt_decode"),
        (2048, 2048, (128, 128, 128), torch.float32, "simt64"),
        (2048, 2048, (8, 128, 128), torch.float32, "simt_decode"),
    ],
)
def test_tile_config_table(n, k, blocks, dtype, want):
    got = tg.tile_config(n, k, *blocks, dtype)
    assert got == want and got in tg.TILE_CONFIGS


# -- the tensor-core tiles on the card -------------------------------------------


@pytest.mark.parametrize("tile", ["tc_rows32", "tc_decode"])
@pytest.mark.parametrize("epi", [{}, dict(bias=True, residual=True, activation="gelu")])
def test_tensor_core_tiles_match_plain_on_card(cuda, tile, epi):
    """Each bf16 tensor-core tile against the plain version with ragged N
    and K, sizes on both sides of a row tile's and a block's end, within
    2^-7 of max|ref| (adjacent bf16 roundings); masked rows exact zeros."""
    g, n, k = 6, 360, 1000
    rpg, bm = (16, 16) if tile == "tc_decode" else (96, 48)
    sizes = [rpg, 0, 1, bm - 1, bm + 1, rpg - 3]
    tokens, sz, _, w = _case(g, rpg, k, n, seed=3, sizes=sizes)
    b, r = _epilogue(g, rpg, n, 13, bias=epi.get("bias", False),
                     residual=epi.get("residual", False))
    t = [None if a is None else a.to(cuda, torch.bfloat16) for a in _t(tokens, sz, w, b, r)]
    t[1] = torch.from_numpy(sz).to(cuda)
    kw = dict(block_m=bm, block_n=128, block_k=128, activation=epi.get("activation"))
    assert tg.tile_config(n, k, bm, 128, 128, torch.bfloat16) == tile
    before = dict(tg.grouped_mesh_matmul.launches_by_config)
    out = tg.grouped_mesh_matmul(t[0], t[1], t[2], bias=t[3], residual=t[4], **kw)
    ref = tg.grouped_mesh_matmul_torch(t[0], t[1], t[2], bias=t[3], residual=t[4], **kw)
    torch.cuda.synchronize()
    assert tg.grouped_mesh_matmul.launches_by_config[tile] == before.get(tile, 0) + 1
    valid = (np.arange(rpg)[None, :] < sz[:, None]).reshape(-1)
    assert not out[torch.from_numpy(~valid).to(cuda)].any()
    scale = 2.0**-7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= scale
