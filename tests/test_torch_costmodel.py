"""Port parity: the cost model (`costmodel/`), its calibration files, the
backend chooser, and the blocks the planner resolves through them.

The same inputs go through `repro.costmodel` and `repro_torch.costmodel`;
backend names are mapped (pallas_mesh -> cuda_mesh, xla -> torch).  Every
test gets fresh autotune and calibration cache files.
"""

import importlib
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.costmodel import choose as tchoose  # noqa: E402
from repro_torch.costmodel import model as tmodel  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402
from repro_torch.resilience import ledger  # noqa: E402

# the package re-exports a `calibrate` FUNCTION that shadows the submodule
tcal = importlib.import_module("repro_torch.costmodel.calibrate")
NAMES = {"pallas_mesh": "cuda_mesh", "xla": "torch", "ref": "ref",
         "pallas_mesh_scrambled": "cuda_mesh_scrambled"}


def _reset(jx=None):
    api.clear_plan_cache()
    api.set_default(None)
    ledger.clear()
    tat.clear_resolve_memo()
    tcal.clear_coefficients_memo()
    tchoose.clear_decision_memo()
    if jx is not None:
        jx.api.clear_plan_cache()
        jx.api.set_default(None)
        jx.ledger.clear()
        jx.autotune.clear_resolve_memo()
        jx.calibrate.clear_coefficients_memo()
        jx.choose.clear_decision_memo()


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "costmodel.json"))
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def jx_mod():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    jcal = importlib.import_module("repro.costmodel.calibrate")
    from repro.costmodel import choose as jchoose
    from repro.costmodel import model as jmodel
    from repro.kernels import api as japi
    from repro.kernels import autotune as jat
    from repro.resilience import ledger as jledger

    return types.SimpleNamespace(jnp=jnp, api=japi, autotune=jat, calibrate=jcal,
                                 choose=jchoose, model=jmodel, ledger=jledger)


@pytest.fixture
def jx(jx_mod):
    _reset(jx_mod)
    yield jx_mod
    _reset(jx_mod)


# --- the blocks repair: mesh-paper and OLMoE at full width --------------------

# mesh-paper (d_model 2048, d_ff 8192, vocab 32768): its projections (K, N)
# at decode (M = 4 slots), prefill (M = 128) and training (M = 2 x 2048).
MESH_PAPER_KN = ((2048, 2048), (2048, 16384), (8192, 2048), (2048, 32768), (2048, 8192))
MESH_PAPER_M = (4, 128, 4096)
# OLMoE-1B-7B's expert products (K, N) over 64 experts, at the rows-per-group
# bounds of a 4-token decode step (8), a 128-token prefill (128) and a
# 2 x 2048-token training step (640).
OLMOE_KN = ((2048, 2048), (1024, 2048))
OLMOE_RPG = (8, 128, 640)


def _full_width_specs(mod):
    specs = []
    for dt in ("bfloat16", "float32"):
        for m in MESH_PAPER_M:
            for k, n in MESH_PAPER_KN:
                specs.append(mod.GemmSpec(m=m, k=k, n=n, dtype_a=dt, dtype_b=dt))
    specs.append(mod.GemmSpec(m=4096, k=2048, n=2048, dtype_a="bfloat16",
                              dtype_b="bfloat16", structure="scrambled"))
    for rpg in OLMOE_RPG:
        for k, n in OLMOE_KN:
            specs.append(mod.GemmSpec.for_groups(mod.GroupSpec(64, rpg), k, n,
                                                 dtype_a="bfloat16", dtype_b="bfloat16"))
    return specs


def test_full_width_plan_blocks_equal_the_reference(jx):
    """Plans only: the port resolves unpinned blocks through the cost model's
    chooser as the reference does, so its k order is the reference's."""
    want = [jx.api.plan(s, backend="pallas_mesh").blocks for s in _full_width_specs(jx.api)]
    got = [api.plan(s, backend="cuda_mesh").blocks for s in _full_width_specs(api)]
    assert got == want
    assert (128, 512, 128) in got and (512, 512, 128) in got  # decode/prefill, training
    assert got[2 * len(MESH_PAPER_M) * len(MESH_PAPER_KN)] == (512, 256, 128)  # scrambled
    assert got[-1] == (128, 512, 128)  # grouped: block_m clamped to divide 640


# --- model arithmetic against the reference ------------------------------------

B = 8


def _ref_name(term_or_rec):
    """A reference record's backend names mapped to the port's."""
    return {k: NAMES.get(v, v) if k == "backend" else v for k, v in term_or_rec.items()}


def _spec_cases(mod):
    return [
        mod.GemmSpec(m=2 * B, k=B, n=B),
        mod.GemmSpec(m=B, k=B, n=B, batch=(4,), batched_b=True),
        mod.GemmSpec(m=B, k=2 * B, n=B, batch=(3,)),
        mod.GemmSpec(m=4 * B, k=4 * B, n=4 * B, structure="symmetric"),
        mod.GemmSpec(m=4 * B, k=2 * B, n=4 * B, structure="scrambled", blocks=(B, B, B)),
        mod.GemmSpec(m=B, k=B, n=B, repeats=8, dtype_a="bfloat16", dtype_b="bfloat16"),
        mod.GemmSpec.for_groups(mod.GroupSpec(4, B), k=B, n=2 * B),
        mod.GemmSpec.for_groups(mod.GroupSpec(4, 16), k=B, n=B, dtype_a="bfloat16",
                                dtype_b="bfloat16"),
    ]


def _describe_pairs(jx):
    out = []
    for js, ts in zip(_spec_cases(jx.api), _spec_cases(api)):
        for jbe, tbe in (("pallas_mesh", "cuda_mesh"), ("ref", "ref")):
            out.append((jx.api.plan(js, backend=jbe).describe(),
                        api.plan(ts, backend=tbe).describe()))
    return out


def test_terms_and_predictions_equal_the_reference(jx):
    jco = jx.model.default_coefficients("cpu")
    tco = tmodel.default_coefficients("cpu")
    for jd, td in _describe_pairs(jx):
        jterms, tterms = jx.model.terms_from_describe(jd), tmodel.terms_from_describe(td)
        assert tterms == _ref_name(jterms)
        assert tmodel.predict(tterms, tco) == jx.model.predict(jterms, jco)
        for be_j, be_t in (("pallas_mesh", "cuda_mesh"), ("xla", "torch"), ("ref", "ref")):
            assert tmodel.predict(tterms, tco, backend=be_t) == \
                jx.model.predict(jterms, jco, backend=be_j)
    for n in (1, 4, 16, 64, 128, 1024):
        assert tmodel.structure_step_factor("symmetric", n) == \
            jx.model.structure_step_factor("symmetric", n)
        for r in (1, 2, 8, 64):
            assert tmodel.repeat_amortization(r, n) == jx.model.repeat_amortization(r, n)
    for blocks in ((128, 128, 128), (512, 256, 128), (129, 129, 129)):
        assert tmodel.predict_blocks_ms(256, 384, 512, blocks, tco) == \
            jx.model.predict_blocks_ms(256, 384, 512, blocks, jco)


def test_shipped_coefficients():
    """`cpu` keeps the reference's numbers (names mapped); `cuda` is the H100
    data sheet, uncalibrated, ranking torch above cuda_mesh."""
    jx = pytest.importorskip("repro.costmodel.model")
    j, t = jx.default_coefficients("cpu"), tmodel.default_coefficients("cpu")
    assert _port_names(j) == t.as_dict()
    co = tmodel.default_coefficients("cuda")
    assert (co.platform, co.source) == ("cuda", "default")
    assert (co.flops_per_s, co.hbm_bytes_per_s, co.link_bytes_per_s) == (989e12, 3.35e12, 450e9)
    assert co.efficiency("torch") == 1.0 > co.efficiency("cuda_mesh") > co.efficiency("ref")
    back = tmodel.CostCoefficients.from_dict({**co.as_dict(), "not_a_field": 1})
    assert back == co and co.efficiency("never_registered") == co.default_efficiency


def _port_names(co):
    d = co.as_dict()
    d["backend_efficiency"] = {NAMES.get(k, k): v for k, v in d["backend_efficiency"].items()}
    return d


def _fit_records(terms_from_describe, predict, truth, plan_desc):
    terms = terms_from_describe(plan_desc)
    records = []
    for scale in (1, 2, 4, 8):
        t = dict(terms)
        t["flops"] *= scale**3
        for k in ("a_bytes", "b_bytes", "out_bytes", "hbm_bytes"):
            t[k] *= scale**2
        records.append({"terms": t, "ms": predict(t, truth)["total_s"] * 1e3})
    return records


def test_fit_coefficients_equals_the_reference(jx):
    import dataclasses

    jd = jx.api.plan(jx.api.GemmSpec(m=64, k=64, n=64), backend="xla").describe()
    td = api.plan(api.GemmSpec(m=64, k=64, n=64), backend="torch").describe()
    jtruth = dataclasses.replace(jx.model.default_coefficients("cpu"), flops_per_s=2.5e10,
                                 hbm_bytes_per_s=5e9, launch_overhead_s=2e-5)
    ttruth = dataclasses.replace(tmodel.default_coefficients("cpu"), flops_per_s=2.5e10,
                                 hbm_bytes_per_s=5e9, launch_overhead_s=2e-5)
    jrecs = _fit_records(jx.model.terms_from_describe, jx.model.predict, jtruth, jd)
    trecs = _fit_records(tmodel.terms_from_describe, tmodel.predict, ttruth, td)
    assert [r["ms"] for r in trecs] == [r["ms"] for r in jrecs]
    jfit = jx.calibrate.fit_coefficients(jrecs, platform="cpu")
    tfit = tcal.fit_coefficients(trecs, platform="cpu")
    assert tfit.source == jfit.source == "calibrated"
    assert _port_names(jfit) == tfit.as_dict()
    assert tcal.fit_coefficients(trecs, platform="cpu") == tfit  # deterministic
    assert tcal._fit_error(trecs, tfit) < tcal._fit_error(trecs, tmodel.default_coefficients())


# --- calibration files ---------------------------------------------------------


def _records_of(jx_or_port, describe_pairs, port):
    out = []
    for i, (jd, td) in enumerate(describe_pairs):
        d = td if port else jd
        terms = (tmodel if port else jx_or_port.model).terms_from_describe(d)
        out.append({"terms": terms, "ms": 0.5 + i, "source": "probe",
                    "key": f"{d['mkn']}|{d['backend']}"})
    return out


def test_calibration_files_read_in_either_package(jx, tmp_path):
    pairs = _describe_pairs(jx)
    # the reference writes; the port reads it with the backend names mapped
    jpath = tmp_path / "ref.json"
    jcache = jx.calibrate.CalibrationCache(jpath)
    jrecs = _records_of(jx, pairs, port=False)
    assert jcache.add_records("cpu", jrecs) == len(jrecs)
    jcache.add_records("tpu", jrecs[:2])
    jfit = jx.calibrate.fit_coefficients(jrecs, platform="cpu")
    jcache.set_coefficients(jfit)
    jcache.save()
    tcache = tcal.CalibrationCache(jpath)
    got = tcache.records("cpu")
    assert [r["terms"] for r in got] == [_ref_name(r["terms"]) for r in jrecs]
    assert [r["key"] for r in got] == [
        f"{r['key'].rsplit('|', 1)[0]}|{NAMES[r['key'].rsplit('|', 1)[1]]}" for r in jrecs]
    assert tcache.records("cuda") == [] and len(tcache.records("tpu")) == 2
    tco = tcache.coefficients("cpu")
    assert tco.as_dict() == dict(_port_names(jfit), source="calibrated")
    assert tco.efficiency("torch") == jfit.efficiency("xla")
    # the port writes; the reference reads it
    tpath = tmp_path / "port.json"
    tc = tcal.CalibrationCache(tpath)
    trecs = _records_of(jx, pairs, port=True)
    tc.add_records("cpu", trecs)
    tc.set_coefficients(tcal.fit_coefficients(trecs, platform="cpu"))
    tc.save()
    back = jx.calibrate.CalibrationCache(tpath)
    assert back.records("cpu") == trecs
    assert back.coefficients("cpu").flops_per_s == tc.coefficients("cpu").flops_per_s
    raw = json.loads(tpath.read_text())
    assert raw["version"] == jx.calibrate.CALIBRATION_VERSION == tcal.CALIBRATION_VERSION
    assert raw["model_version"] == jx.model.COST_MODEL_VERSION


def test_a_reference_record_of_another_platform_never_reaches_the_card(tmp_path,
                                                                         monkeypatch):
    path = tmp_path / "costmodel.json"
    path.write_text(json.dumps({
        "version": 1, "model_version": 1,
        "coefficients": {"gpu": {"flops_per_s": 1e9, "hbm_bytes_per_s": 1e9,
                                 "link_bytes_per_s": 1e9}},
        "records": {"gpu": [{"terms": {"flops": 1000}, "ms": 1.0, "source": "probe"}]}}))
    co = tcal.current_coefficients("cuda")
    assert co == tmodel.default_coefficients("cuda") and co.source == "default"
    assert tcal.default_cache().records("cuda") == []


def test_calibration_cache_quarantines_corrupt_file(tmp_path):
    path = tmp_path / "cal.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        cache = tcal.CalibrationCache(path)
        assert cache.coefficients("cpu") is None
    assert (tmp_path / "cal.json.corrupt").exists()
    assert [e.fallback for e in ledger.events("costmodel.cache_load")] == ["quarantine"]
    cache.set_coefficients(tmodel.default_coefficients("cpu"))
    cache.save()
    assert tcal.CalibrationCache(path).coefficients("cpu") is not None


def test_calibration_cache_drops_invalid_records_and_versions(tmp_path):
    path = tmp_path / "cal.json"
    good = {"terms": {"flops": 1000}, "ms": 1.0, "source": "probe"}
    path.write_text(json.dumps({
        "version": tcal.CALIBRATION_VERSION, "model_version": tmodel.COST_MODEL_VERSION,
        "coefficients": {"cpu": {"flops_per_s": -1}},
        "records": {"cpu": [good, {"ms": -3}, "junk"]}}))
    with pytest.warns(UserWarning, match="dropped 3 invalid"):
        cache = tcal.CalibrationCache(path)
        assert cache.coefficients("cpu") is None
        assert cache.records("cpu") == [good]
    path.write_text(json.dumps({"version": 999, "coefficients": {"cpu": {}}}))
    assert tcal.CalibrationCache(path).coefficients("cpu") is None


def test_calibrate_round_trip_installs_coefficients():
    assert tcal.current_coefficients("cpu").source == "default"
    got = tcal.calibrate(platform="cpu", shapes=((16, 16, 16), (64, 64, 64)))
    assert got.source == "calibrated" and got.platform == "cpu"
    assert tcal.current_coefficients("cpu") == got  # memo refreshed
    tcal.clear_coefficients_memo()
    assert tcal.current_coefficients("cpu") == got  # persisted + reloaded
    assert [r["source"] for r in tcal.default_cache().records("cpu")] == ["probe", "probe"]


def test_hillclimb_gemm_variant_writes_ingestible_records(tmp_path):
    from repro_torch.launch.hillclimb import GEMM_VARIANTS, main, run_gemm_variant

    jh = pytest.importorskip("repro.launch.hillclimb")
    assert GEMM_VARIANTS == jh.GEMM_VARIANTS
    rec = run_gemm_variant("G0_tiny", out_dir=str(tmp_path), reps=1, device="cpu")
    assert tcal._valid_record(rec) and rec["source"] == "hillclimb"
    assert tcal._valid_record(json.loads((tmp_path / "gemm__G0_tiny.json").read_text()))
    assert tcal.ingest([rec], platform="cpu") == 1
    assert tcal.current_coefficients("cpu").source == "calibrated"
    main(["--gemm", "--variant", "G5_repeats8", "--device", "cpu", "--out", str(tmp_path),
          "--ingest"])
    assert len(tcal.default_cache().records("cpu")) == 2
    with pytest.raises(SystemExit):
        main(["--cell", "E"])  # no such dry-run cell (A-D: tests/test_torch_hillclimb.py)


def test_roofline_analyze_plan_consumes_the_cost_terms(jx):
    from repro_torch.launch import roofline

    jr = pytest.importorskip("repro.launch.roofline")
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    for jd, td in _describe_pairs(jx):
        rl = roofline.analyze_plan(td)
        t = tmodel.terms_from_describe(td)
        assert rl["terms"] == t and rl["hbm_bytes"] == t["hbm_bytes"]
        assert rl["per_shard_flops"] == t["flops"]
        assert rl["t_compute_s"] == t["flops"] / 989e12
        assert rl["t_memory_s"] == t["hbm_bytes"] / 3.35e12
        j = jr.analyze_plan(jd)
        assert rl["dominant"] in ("compute", "memory") and rl["hbm_bytes"] == j["hbm_bytes"]
        assert ("grouped" in rl) == ("grouped" in j)
        if "grouped" in rl:
            assert rl["grouped"]["dispatch_bytes"] == j["grouped"]["dispatch_bytes"]
        json.dumps(rl)


# --- decisions -----------------------------------------------------------------


def test_decide_backend_equals_the_reference(jx):
    for js, ts in zip(_spec_cases(jx.api)[:4], _spec_cases(api)[:4]):
        jchosen, jdec = jx.choose.decide_backend(js, [("xla", 0), ("pallas_mesh", 1),
                                                      ("ref", 2)])
        tchosen, tdec = tchoose.decide_backend(ts, [("torch", 0), ("cuda_mesh", 1),
                                                    ("ref", 2)], platform="cpu")
        assert tchosen == NAMES[jchosen] == "torch"
        jrows = [_ref_name(dict(r, backend=r["name"])) for r in jdec.as_dict()["candidates"]]
        trows = [dict(r, backend=r["name"]) for r in tdec.as_dict()["candidates"]]
        assert [(r["backend"], r["predicted_s"], r["efficiency"]) for r in trows] == \
            [(r["backend"], r["predicted_s"], r["efficiency"]) for r in jrows]
        assert tdec.calibration == jdec.calibration == {
            "model_version": 1, "source": "default", "platform": "cpu"}
    _, cdec = tchoose.decide_backend(_spec_cases(api)[0], [("torch", 0), ("cuda_mesh", 1),
                                                           ("ref", 2)], platform="cuda")
    assert [c["name"] for c in cdec.candidates] == ["torch", "cuda_mesh", "ref"]


def test_plan_records_backend_decision(jx):
    jp = jx.api.plan(jx.api.GemmSpec(m=B, k=B, n=B))
    tp = api.plan(api.GemmSpec(m=B, k=B, n=B), device="cpu")
    assert tp.backend == NAMES[jp.backend] == "torch"
    d = tp.describe()
    json.dumps(d)
    dec, jdec = d["decision"]["backend"], jp.describe()["decision"]["backend"]
    assert dec["chosen"] == "torch" and [c["name"] for c in dec["candidates"]] == \
        [NAMES[c["name"]] for c in jdec["candidates"]]
    assert api.plan(api.GemmSpec(m=B, k=B, n=B), backend="ref").decision is None
    with api.default_backend("cuda_mesh"):  # a capable pinned default: no decision
        assert api.plan(api.GemmSpec(m=B, k=B, n=2 * B)).decision is None


def test_a_failing_cost_model_degrades_to_the_first_capable_backend(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no model")

    monkeypatch.setattr(tchoose, "decide_backend", boom)
    p = api.plan(api.GemmSpec(m=B, k=B, n=B), device="cpu")
    assert p.backend == "torch" and p.decision is None
    assert [(e.site, e.fallback) for e in ledger.events()] == [
        ("costmodel.decide_backend", "torch")]


def test_calibrated_coefficients_rank_blocks_by_predicted_time(jx, tmp_path):
    """Once the file holds a fit, both packages rank block candidates by
    `predict_blocks_ms` and return a `blocks` decision."""
    import dataclasses

    for cal_mod, model_mod in ((jx.calibrate, jx.model), (tcal, tmodel)):
        c = cal_mod.default_cache()
        c.set_coefficients(dataclasses.replace(model_mod.default_coefficients("cpu"),
                                               hbm_bytes_per_s=1e9))
        c.save()
        cal_mod.clear_coefficients_memo()
    jblocks, jdec = jx.choose.choose_blocks(512, 512, 512, "float32", "pallas_mesh")
    tblocks, tdec = tchoose.choose_blocks(512, 512, 512, "float32", "cuda_mesh", platform="cpu")
    assert tblocks == jblocks and tdec.as_dict() == jdec.as_dict()
    assert tdec.kind == "blocks" and tdec.calibration["source"] == "calibrated"


def test_scheduler_warmup_preloads_the_coefficients(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.scheduler import ContinuousBatchingServer, ServeConfig
    from repro_torch.models import get_model

    cfg = get_config("mesh-paper").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    server = ContinuousBatchingServer(model, params, ServeConfig(
        max_slots=1, page_size=8, num_pages=3, max_pages_per_seq=2), device="cpu")
    assert tcal._COEFFS_MEMO == {}
    server.warmup()
    assert [k[0] for k in tcal._COEFFS_MEMO] == ["cpu"]
