"""Port parity: the GEMM planner's degradation ladder, non-finite guard,
default-backend scope, dispatch, and the legacy `ops.matmul` shim.

Each ladder scenario runs in both packages on the same numpy operands with
the same fault plan and `fallback=` passed explicitly (the port defaults to
False, the reference to True).  The (site, fallback) sequence of the
DegradationEvents must be equal with the backend names mapped (pallas_mesh
-> cuda_mesh, xla -> torch), and a degraded plan's output must equal the
fallback backend run directly, bitwise, inside each package.
"""

import types
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.api import GemmSpec  # noqa: E402
from repro_torch.resilience import faults, ledger  # noqa: E402
from repro_torch.resilience import policy  # noqa: E402

B = 8
NAMES = {"pallas_mesh": "cuda_mesh", "xla": "torch", "ref": "ref"}
F32 = dict(rtol=1e-5, atol=1e-5)


def _reset_port():
    api.clear_plan_cache()
    api.set_default(None)
    ledger.clear()
    ops._WARNED.clear()
    ops._LEGACY_DEFAULT = ops._LEGACY_EPOCH = None


@pytest.fixture(autouse=True)
def _clean_port():
    _reset_port()
    yield
    _reset_port()


@pytest.fixture(scope="module")
def jx_mod():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro.resilience import faults as jfaults
    from repro.resilience import ledger as jledger
    from repro.resilience import policy as jpolicy

    return types.SimpleNamespace(jax=jax, jnp=jnp, api=japi, faults=jfaults,
                                 ledger=jledger, policy=jpolicy)


@pytest.fixture
def jx(jx_mod):
    """The JAX reference with a fresh plan cache, default and ledger."""
    def reset():
        jx_mod.api.clear_plan_cache()
        jx_mod.api.set_default(None)
        jx_mod.ledger.clear()

    reset()
    yield jx_mod
    reset()


def _events(health, mapped=False):
    return [(e.site, NAMES.get(e.fallback, e.fallback) if mapped else e.fallback)
            for e in health]


def _mats(m=2 * B, k=B, n=B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _both(jx, *arrays):
    return [jx.jnp.asarray(x) for x in arrays], [torch.from_numpy(x) for x in arrays]


def _case(structure, seed=0):
    """numpy operands and spec kwargs of each structure (the reference's
    `_spec_and_args`)."""
    if structure == "grouped":
        rng = np.random.default_rng(seed)
        g, rpg, k, n = 4, 16, 24, 20
        tokens = rng.normal(size=(g * rpg, k)).astype(np.float32)
        w = rng.normal(size=(g, k, n)).astype(np.float32)
        sizes = rng.integers(0, rpg + 1, size=g).astype(np.int32)
        valid = (np.arange(rpg)[None, :] < sizes[:, None]).reshape(-1, 1)
        tokens = tokens * valid
        off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        return (tokens, off, w), dict(group=(g, rpg, k, n))
    if structure == "symmetric":
        a, _ = _mats(m=2 * B, k=2 * B, seed=seed)
        return (a, np.ascontiguousarray(a.T)), dict(structure="symmetric")
    a, b = (_mats(m=2 * B, k=B, n=2 * B, seed=seed) if structure == "general"
            else _mats(m=B, k=B, n=B, seed=seed))
    return (a, b), dict(structure=structure)


def _spec(mod, arrays, kw):
    if "group" in kw:
        g, rpg, k, n = kw["group"]
        return mod.GemmSpec.for_groups(mod.GroupSpec(g, rpg), k, n)
    return mod.GemmSpec.from_operands(arrays[0], arrays[1], structure=kw["structure"],
                                      blocks=(B, B, B))


def _eq(x, y):
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- plan build fallback -------------------------------------------------------


def test_plan_build_falls_back_down_the_chain(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats())
    jspec = jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B))
    tspec = GemmSpec.from_operands(ta, tb, blocks=(B, B, B))
    with jx.faults.inject({"plan.build": jx.faults.FaultSpec(match={"backend": "pallas_mesh"})}):
        jp = jx.api.plan(jspec, backend="pallas_mesh", fallback=True)
    with faults.inject({"plan.build": faults.FaultSpec(match={"backend": "cuda_mesh"})}):
        tp = api.plan(tspec, backend="cuda_mesh", fallback=True)
    assert tp.backend == NAMES[jp.backend] == "torch"
    assert _events(tp.health) == _events(jp.health, mapped=True) == [("plan.build", "torch")]
    health = tp.describe()["health"]
    assert health["degraded"] and health["active_backend"] == "torch"
    assert health["fallback_chain"] == ["ref"]
    assert _events(ledger.events("plan.build")) == [("plan.build", "torch")]
    got = tp(ta, tb)
    _eq(got, api.plan(tspec, backend="torch")(ta, tb))  # IS the fallback's executor
    np.testing.assert_allclose(got.numpy(), np.asarray(jp(ja, jb)), **F32)


def test_plan_build_fallback_false_raises(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(n=2 * B, seed=1))
    with jx.faults.inject({"plan.build": jx.faults.FaultSpec()}):
        with pytest.raises(jx.faults.FaultError):
            jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)), fallback=False)
    for kw in (dict(fallback=False), {}):  # False is the port's default
        with faults.inject({"plan.build": faults.FaultSpec()}):
            with pytest.raises(faults.FaultError):
                api.plan(GemmSpec.from_operands(ta, tb, blocks=(B, B, B)), **kw)
    assert ledger.count() == 0


def test_spec_validation_errors_never_fall_back(jx):
    for mod, lg in ((jx.api, jx.ledger), (api, ledger)):
        spec = mod.GemmSpec(m=B + 1, k=B, n=B + 1, structure="scrambled", blocks=(B, B, B))
        with pytest.raises(mod.PlanValidationError):
            mod.plan(spec, fallback=True)
        assert isinstance(mod.PlanValidationError("x"), ValueError)
        assert lg.count() == 0


def test_fallback_chain_order_and_exhaustion(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=2))
    with jx.faults.inject({"plan.build": jx.faults.FaultSpec(times=99)}):
        with pytest.raises(jx.faults.FaultError):
            jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)), fallback=True)
    with faults.inject({"plan.build": faults.FaultSpec(times=99)}):
        with pytest.raises(faults.FaultError):
            api.plan(GemmSpec.from_operands(ta, tb, blocks=(B, B, B)), fallback=True)
    want = _events(jx.ledger.events(), mapped=True)
    assert _events(ledger.events()) == want == [("plan.build", "cuda_mesh"),
                                                ("plan.build", "ref")]
    assert api.FALLBACK_ORDER == tuple(NAMES[n] for n in jx.api.FALLBACK_ORDER)


# --- execution-time degrade (bitwise parity per structure) ---------------------


@pytest.mark.parametrize("structure", ["general", "symmetric", "scrambled", "grouped"])
def test_execute_degrade_bitwise_equals_direct_fallback(jx, structure):
    arrays, kw = _case(structure)
    jargs, targs = _both(jx, *arrays)
    jspec, tspec = _spec(jx.api, jargs, kw), _spec(api, targs, kw)
    jp = jx.api.plan(jspec, backend="pallas_mesh", fallback=True)
    tp = api.plan(tspec, backend="cuda_mesh", fallback=True)
    with jx.faults.inject({"plan.execute": jx.faults.FaultSpec(times=1)}):
        jgot = jp(*jargs)
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        got = tp(*targs)
    assert tp.active_backend == NAMES[jp.active_backend] != "cuda_mesh"
    assert _events(tp.health) == _events(jp.health, mapped=True) == [
        ("plan.execute", tp.active_backend)]
    want = api.plan(tspec, backend=tp.active_backend)(*targs)
    _eq(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **F32)
    # the swap is permanent: the next call reuses the fallback, no new events
    _eq(tp(*targs), want)
    assert len(tp.health) == 1


def test_execute_degrade_chain_exhaustion_raises(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=3))
    jp = jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)),
                     backend="pallas_mesh", fallback=True)
    tp = api.plan(GemmSpec.from_operands(ta, tb, blocks=(B, B, B)), backend="cuda_mesh",
                  fallback=True)
    with jx.faults.inject({"plan.execute": jx.faults.FaultSpec(times=99)}):
        with pytest.raises(RuntimeError, match="exhausted"):
            jp(ja, jb)
    with faults.inject({"plan.execute": faults.FaultSpec(times=99)}):
        with pytest.raises(RuntimeError, match="exhausted"):
            tp(ta, tb)
    assert _events(tp.health) == _events(jp.health, mapped=True) == [
        ("plan.execute", "torch"), ("plan.execute", "ref")]


@pytest.mark.parametrize("structure", ["general", "grouped"])
def test_execute_fault_without_ladder_raises(structure):
    """The port's default: no ladder, so a failing backend's error surfaces
    and nothing is recorded."""
    arrays, kw = _case(structure, seed=4)
    targs = [torch.from_numpy(x) for x in arrays]
    spec = _spec(api, targs, kw)
    tp = api.plan(spec, backend="cuda_mesh")
    assert tp is api.plan(spec, backend="cuda_mesh", fallback=False)
    assert tp is not api.plan(spec, backend="cuda_mesh", fallback=True)  # keyed apart
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        with pytest.raises(faults.FaultError):
            tp(*targs)
    assert tp.active_backend == "cuda_mesh" and not tp.health and ledger.count() == 0
    assert tp.describe()["health"]["fallback_chain"] == []


# --- guard_nonfinite -----------------------------------------------------------


def test_guard_zero_and_record_scrubs_eagerly(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=4))
    jp = jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)), backend="xla",
                     guard_nonfinite="zero-and-record", fallback=True)
    spec = GemmSpec.from_operands(ta, tb, blocks=(B, B, B))
    tp = api.plan(spec, backend="torch", guard_nonfinite="zero-and-record", fallback=True)
    with jx.faults.inject({"kernel.output": jx.faults.FaultSpec(poison="nan")}):
        jout = np.asarray(jp(ja, jb))
    with faults.inject({"kernel.output": faults.FaultSpec(poison="nan")}):
        out = tp(ta, tb).numpy()
    assert np.isfinite(out).all() and out[0, 0] == 0.0 == jout[0, 0]
    assert _events(tp.health) == _events(jp.health, mapped=True) == [
        ("guard.nonfinite", "zero")]
    # untouched elements pass through bit for bit
    _eq(out.ravel()[1:], api.plan(spec, backend="torch")(ta, tb).numpy().ravel()[1:])


def test_guard_raise_policy(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=5))
    jp = jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)), backend="xla",
                     guard_nonfinite="raise", fallback=True)
    tp = api.plan(GemmSpec.from_operands(ta, tb, blocks=(B, B, B)), backend="torch",
                  guard_nonfinite="raise", fallback=True)
    with jx.faults.inject({"kernel.output": jx.faults.FaultSpec(poison="inf")}):
        with pytest.raises(jx.policy.NonFiniteError, match="non-finite"):
            jp(ja, jb)
    with faults.inject({"kernel.output": faults.FaultSpec(poison="inf")}):
        with pytest.raises(policy.NonFiniteError, match="non-finite"):
            tp(ta, tb)
    tp(ta, tb)  # clean outputs pass the guard
    assert not tp.health and not jp.health


def test_guard_fallback_policy_switches_backend(jx):
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=6))
    jp = jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)),
                     backend="pallas_mesh", guard_nonfinite="fallback", fallback=True)
    spec = GemmSpec.from_operands(ta, tb, blocks=(B, B, B))
    tp = api.plan(spec, backend="cuda_mesh", guard_nonfinite="fallback", fallback=True)
    with jx.faults.inject({"kernel.output": jx.faults.FaultSpec(
            poison="nan", match={"backend": "pallas_mesh"})}):
        jp(ja, jb)
    with faults.inject({"kernel.output": faults.FaultSpec(
            poison="nan", match={"backend": "cuda_mesh"})}):
        out = tp(ta, tb)
    assert tp.active_backend == NAMES[jp.active_backend] == "torch"
    assert _events(tp.health) == _events(jp.health, mapped=True) == [
        ("guard.nonfinite", "torch")]
    assert torch.isfinite(out).all()
    _eq(out, api.plan(spec, backend="torch")(ta, tb))


@pytest.mark.parametrize("policy_name,fallback", [("zero_and_record", []),
                                                  ("raise", [("guard.nonfinite", "unchecked")])])
def test_guard_under_compile_matches_guard_under_jit(jx, policy_name, fallback):
    """Under a trace the values are unknown: zero_and_record scrubs
    unconditionally, raise lets the poison through and records the gap."""
    (ja, jb), (ta, tb) = _both(jx, *_mats(seed=7))
    jp = jx.api.plan(jx.api.GemmSpec.from_operands(ja, jb, blocks=(B, B, B)), backend="xla",
                     guard_nonfinite=policy_name, fallback=True)
    tp = api.plan(GemmSpec.from_operands(ta, tb, blocks=(B, B, B)), backend="torch",
                  guard_nonfinite=policy_name, fallback=True)
    with jx.faults.inject({"kernel.output": jx.faults.FaultSpec(poison="nan")}):
        jout = np.asarray(jx.jax.jit(lambda x, y: jp(x, y))(ja, jb))
    torch._dynamo.reset()
    compiled = torch.compile(lambda x, y: tp(x, y), backend="eager")
    with faults.inject({"kernel.output": faults.FaultSpec(poison="nan")}):
        out = compiled(ta, tb).numpy()
    assert np.isnan(out[0, 0]) == np.isnan(jout[0, 0]) == (policy_name == "raise")
    assert np.isfinite(out.ravel()[1:]).all()
    assert _events(tp.health) == _events(jp.health) == fallback


def test_guard_sample_and_policy_validation(jx):
    a, b = _mats(seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    spec = GemmSpec.from_operands(ta, tb, blocks=(B, B, B))
    with pytest.raises(ValueError, match="guard policy"):
        api.plan(spec, guard_nonfinite="explode")
    # sampling keys a distinct cache entry and still catches element 0
    p = api.plan(spec, backend="torch", guard_nonfinite="raise", guard_sample=4)
    assert p is not api.plan(spec, backend="torch", guard_nonfinite="raise")
    with faults.inject({"kernel.output": faults.FaultSpec(poison="nan")}):
        with pytest.raises(policy.NonFiniteError):
            p(ta, tb)


# --- policy primitives ---------------------------------------------------------


@pytest.mark.parametrize("sample", [None, 1, 4, 7, 1000])
def test_nonfinite_count_and_scrub_match_reference(jx, sample):
    x = np.random.default_rng(11).normal(size=(9, 13)).astype(np.float32)
    x.ravel()[[0, 5, 17, 40, 116]] = [np.nan, np.inf, -np.inf, np.nan, np.inf]
    j, t = jx.jnp.asarray(x), torch.from_numpy(x)
    assert policy.nonfinite_count(t, sample) == jx.policy.nonfinite_count(j, sample)
    _eq(policy.scrub_nonfinite(t).numpy(), jx.policy.scrub_nonfinite(j))
    for name in ("raise", "fallback", "zero-and-record", "zero_and_record"):
        assert policy.normalize_policy(name) == jx.policy.normalize_policy(name)
    assert policy.GUARD_POLICIES == jx.policy.GUARD_POLICIES


def test_retry_call_backs_off_records_and_recovers(jx):
    def run(retry_call, lg):
        calls, sleeps = [], []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("disk blip")
            return "ok"

        out = retry_call(fn, retries=3, base_delay=0.05, max_delay=1.0, retry_on=(OSError,),
                         site="t.retry", sleep=sleeps.append)
        return out, len(calls), sleeps, [(e.fallback, e.detail) for e in lg.events("t.retry")]

    got = run(policy.retry_call, ledger)
    assert got == run(jx.policy.retry_call, jx.ledger)
    assert got[:3] == ("ok", 3, [0.05, 0.1])
    assert [f for f, _ in got[3]] == ["retry#1", "retry#2"]


def test_retry_call_exhaustion_and_unlisted_errors():
    def permanent():
        raise OSError("permanent")

    with pytest.raises(OSError, match="permanent"):
        policy.retry_call(permanent, retries=1, base_delay=0.0, site="t.retry2",
                          sleep=lambda s: None)
    assert ledger.count("t.retry2") == 1  # the final raise is not a "retry"

    def unlisted():
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        policy.retry_call(unlisted, retries=5, retry_on=(OSError,), sleep=lambda s: None)
    with pytest.raises(ValueError, match="retries"):
        policy.retry_call(unlisted, retries=-1)
    assert ledger.count() == 1


# --- backend choice, defaults, dispatch -----------------------------------------


def test_auto_choice_and_default_backend_scope(jx):
    for mod, xla, mesh in ((jx.api, "xla", "pallas_mesh"), (api, "torch", "cuda_mesh")):
        spec = mod.GemmSpec(m=B, k=B, n=B, blocks=(B, B, B))
        scrambled = mod.GemmSpec(m=B, k=B, n=B, structure="scrambled", blocks=(B, B, B))
        assert mod.plan(spec).backend == xla
        assert mod.plan(scrambled).backend == mesh  # the xla stand-in can't scramble
        epoch = mod.default_epoch()
        with mod.default_backend(mesh):
            assert mod.get_default() == mesh and mod.plan(spec).backend == mesh
        assert mod.get_default() is None and mod.default_epoch() == epoch + 2
        assert mod.plan(spec).backend == xla
        with pytest.raises(ValueError, match="unknown backend"):
            with mod.default_backend("nope"):
                pass
        with mod.default_backend(xla):  # a pinned default that can't is skipped
            assert mod.plan(scrambled).backend == mesh


def test_dispatch_and_execute_async_equal_sequential_calls():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2 * B, B)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)) for n in (B, 2 * B, B)]
    plans = [api.plan(GemmSpec.from_operands(x, w, blocks=(B, B, B)), backend=be)
             for w, be in zip(ws, ("cuda_mesh", "torch", "cuda_mesh"))]
    want = [p(x, w) for p, w in zip(plans, ws)]
    handle = plans[0].dispatch(x, ws[0])
    assert isinstance(handle, api.AsyncResult) and handle.plan is plans[0]
    _eq(handle.block(), want[0])
    got = api.execute_async([(p, (x, w)) for p, w in zip(plans, ws)])
    for g, w in zip(got, want):
        _eq(g, w)
    arrays, kw = _case("grouped", seed=3)
    targs = [torch.from_numpy(a) for a in arrays]
    gp = api.plan(_spec(api, targs, kw), backend="cuda_mesh")
    _eq(gp.dispatch(*targs).block(), gp(*targs))
    assert plans[0].executor(x, ws[0], None, None).equal(want[0])
    with pytest.raises(ValueError, match="do not match"):
        plans[0].dispatch(ws[0], x)


# --- the ops.matmul compat shim -------------------------------------------------


def _dep(rec):
    return [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_compat_deprecation_warning_fires_exactly_once():
    a = torch.from_numpy(_mats(m=B, seed=15)[1])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ops.matmul(a, a, backend="torch")
        ops.matmul(a, a, backend="torch")
        ops.matmul(a, a, backend="cuda_mesh", block_m=B, block_n=B, block_k=B)
    dep = _dep(rec)
    assert len(dep) == 1 and "backend= strings" in str(dep[0].message)
    assert dep[0].filename == __file__  # attributed to the external caller
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ops.matmul(a, a)  # no string backend: nothing to warn about
    assert not _dep(rec)


def test_invalid_backend_string_does_not_consume_warning():
    a = torch.from_numpy(_mats(m=B, seed=21)[1])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with pytest.raises(ValueError, match="backend must be one of"):
            ops.matmul(a, a, backend="typo")
        ops.matmul(a, a, backend="torch")  # the one-shot warning still fires
    assert len(_dep(rec)) == 1


def test_set_default_backend_deprecated_but_functional():
    a = torch.from_numpy(_mats(m=B, seed=16)[1])
    with pytest.deprecated_call():
        ops.set_default_backend("cuda_mesh")
    assert ops.get_default_backend() == "cuda_mesh"
    out = ops.matmul(a, a, block_m=B, block_n=B, block_k=B)
    np.testing.assert_allclose(out.numpy(), (a @ a).numpy(), rtol=1e-4, atol=1e-4)
    [entry] = api.plan_cache_info()["plans"]
    assert entry["backend"] == "cuda_mesh" and entry["device"] == "cpu"
    with pytest.raises(ValueError, match="backend must be one of"):
        ops.set_default_backend("bogus")


def test_scoped_default_backend_reaches_compat_shim():
    a = torch.from_numpy(_mats(m=B, seed=20)[1])
    with api.default_backend("cuda_mesh"):
        ops.matmul(a, a, block_m=B, block_n=B, block_k=B)
    [entry] = api.plan_cache_info()["plans"]
    assert entry["backend"] == "cuda_mesh"
    assert ops.get_default_backend() == "torch"  # scope ended


def test_scoped_default_supersedes_stale_legacy_scrambled_default():
    g = 3
    a = torch.from_numpy(np.random.default_rng(22).normal(size=(g * B, g * B)).astype(np.float32))
    with pytest.deprecated_call():
        ops.set_default_backend("cuda_mesh_scrambled")
    assert ops.get_default_backend() == "cuda_mesh_scrambled"
    with api.default_backend("cuda_mesh"):
        got = ops.matmul(a, a, block_m=B, block_n=B, block_k=B)
    np.testing.assert_allclose(got.numpy(), (a @ a).numpy(), rtol=1e-4, atol=1e-4)
    api.set_default(None)  # explicit auto-choice also supersedes
    assert ops.get_default_backend() == "torch"


def test_scrambled_alias_bitwise_vs_direct_plan(jx):
    """`cuda_mesh_scrambled` is structure='scrambled' on cuda_mesh: the same
    plan, bitwise; and close to the reference's alias."""
    g = 3
    rng = np.random.default_rng(8)
    a = rng.normal(size=(g * B, 2 * B)).astype(np.float32)
    b = rng.normal(size=(2 * B, g * B)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    spec = GemmSpec.from_operands(ta, tb, structure="scrambled", blocks=(B, B, B))
    want = api.plan(spec, backend="cuda_mesh")(ta, tb)
    with pytest.deprecated_call():
        got = ops.matmul(ta, tb, backend="cuda_mesh_scrambled", block_m=B, block_n=B, block_k=B)
    _eq(got, want)
    from repro.kernels import ops as jops

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jwant = jops.matmul(jx.jnp.asarray(a), jx.jnp.asarray(b),
                            backend="pallas_mesh_scrambled", block_m=B, block_n=B, block_k=B)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32)


def test_shim_epilogue_matches_reference(jx):
    from repro.kernels import ops as jops

    rng = np.random.default_rng(30)
    a = rng.normal(size=(2, B, 2 * B)).astype(np.float32)
    w = rng.normal(size=(2 * B, B)).astype(np.float32)
    bias = rng.normal(size=(B,)).astype(np.float32)
    res = rng.normal(size=(2, B, B)).astype(np.float32)
    kw = dict(activation="gelu", block_m=B, block_n=B, block_k=B)
    got = ops.matmul(*(torch.from_numpy(x) for x in (a, w)), bias=torch.from_numpy(bias),
                     residual=torch.from_numpy(res), **kw)
    want = jops.matmul(*(jx.jnp.asarray(x) for x in (a, w)), bias=jx.jnp.asarray(bias),
                       residual=jx.jnp.asarray(res), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def test_plan_execute_degrade_on_card_from_k1(cuda):
    """A fallback=True K1 plan degrades to `torch` under one injected
    plan.execute fault; its output equals the torch plan's bitwise, and a
    fallback=False plan raises."""
    from repro_torch.kernels import mesh_matmul

    rng = np.random.default_rng(40)
    a = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32)).to(cuda,
                                                                          torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)).to(cuda,
                                                                          torch.bfloat16)
    spec = GemmSpec.from_operands(a, b, out_dtype=torch.float32)
    p = api.plan(spec, backend="cuda_mesh", device=cuda, fallback=True)
    before = mesh_matmul.mesh_matmul.launches
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        got = p(a, b)
    assert p.active_backend == "torch" and _events(p.health) == [("plan.execute", "torch")]
    assert mesh_matmul.mesh_matmul.launches == before
    _eq(got.cpu(), api.plan(spec, backend="torch", device=cuda)(a, b).cpu())
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        with pytest.raises(faults.FaultError):
            api.plan(spec, backend="cuda_mesh", device=cuda)(a, b)


def test_torch_backend_bf16_f32_out_on_card(cuda):
    """The torch backend's bf16 GEMM with an f32 output against the f32
    GEMM of the upcast operands (both sum in f32), and its gradients."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.normal(size=(3, 64, 256)).astype(np.float32)).to(cuda,
                                                                             torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)).to(cuda,
                                                                           torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(3, 64, 128)).astype(np.float32)).to(cuda)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    z = api._matmul_f32(xr, wr)
    assert z.dtype == torch.float32
    z.backward(g)
    x2, w2 = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    z2 = torch.matmul(x2.float(), w2.float())
    z2.backward(g)
    tol = 1e-5 * z2.abs().max().item()
    assert (z - z2).abs().max().item() <= tol
    assert xr.grad.dtype == torch.bfloat16 and torch.equal(xr.grad, x2.grad)
    assert torch.equal(wr.grad, w2.grad)
    wb = torch.from_numpy(rng.normal(size=(3, 256, 32)).astype(np.float32)).to(cuda,
                                                                              torch.bfloat16)
    zb = api._matmul_f32(x, wb)
    assert (zb - torch.matmul(x.float(), wb.float())).abs().max().item() <= \
        1e-5 * zb.abs().max().item()
