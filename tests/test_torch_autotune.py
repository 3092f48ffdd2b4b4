"""Port parity: the block autotuner (`kernels/autotune.py`).

On the CPU the port's candidates, scores, cache keys and resolved blocks
equal the reference's on the same shapes (backend names mapped:
pallas_mesh -> cuda_mesh).  On the card a candidate is legal only where K1
runs the product on a tensor-core or f32 tile; that filter is checked here
on shapes alone, with no card.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import mesh_matmul as tmm  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    CACHE_VERSION,
    AutotuneCache,
    cache_key,
    candidate_blocks,
    model_score,
    vmem_bytes,
)
from repro_torch.resilience import ledger  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Shapes (M, K, N): mesh-paper's decode, prefill and training products,
# small and ragged ones, and a square scrambled grid.
SHAPES = [(4, 2048, 2048), (128, 8192, 2048), (4096, 2048, 32768), (100, 4096, 100),
          (48, 32, 24), (640, 1024, 2048), (384, 384, 384), (4096, 4096, 4096)]


@pytest.fixture
def jat():
    pytest.importorskip("jax")
    from repro.kernels import autotune as jat

    return jat


@pytest.fixture()
def cache(tmp_path):
    return AutotuneCache(tmp_path / "cache.json")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "default.json"))
    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "costmodel.json"))
    autotune.clear_resolve_memo()
    ledger.clear()
    yield
    autotune.clear_resolve_memo()
    ledger.clear()


# --- the reference's arithmetic on the CPU ------------------------------------


def test_cache_key_and_vmem_model_equal_the_reference(jat):
    for dt in DTYPES:
        assert cache_key(4096, 4096, 4096, DTYPES[dt], "cuda_mesh", platform="cpu") == \
            jat.cache_key(4096, 4096, 4096, dt, "pallas_mesh", platform="cpu").replace(
                "pallas_mesh", "cuda_mesh")
        for blocks in ((128, 128, 128), (512, 256, 128), (128, 512, 512)):
            for bias, res in ((False, False), (True, False), (True, True)):
                assert vmem_bytes(*blocks, DTYPES[dt], has_bias=bias, has_residual=res) == \
                    jat.vmem_bytes(*blocks, dt, has_bias=bias, has_residual=res)
    assert cache_key(8, 16, 32, "bfloat16", "cuda_mesh", symmetry=1, platform="cuda") == \
        "8x16x32|bfloat16|cuda_mesh|sym1|cuda"


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_cpu_candidates_scores_and_blocks_equal_the_reference(jat, tmp_path, m, k, n, dt):
    kw = dict(has_bias=True, has_residual=True)
    want = jat.candidate_blocks(m, k, n, dt, **kw)
    got = candidate_blocks(m, k, n, DTYPES[dt], platform="cpu", **kw)
    assert got == want
    tight = dict(kw, vmem_budget=300 * 1024)
    assert candidate_blocks(m, k, n, DTYPES[dt], **tight) == jat.candidate_blocks(m, k, n, dt,
                                                                                  **tight)
    assert [model_score(m, k, n, c, DTYPES[dt]) for c in got] == \
        [jat.model_score(m, k, n, c, dt) for c in want]
    for be in ("mesh", "mesh_scrambled"):
        jblocks = jat.autotune(m, k, n, dt, f"pallas_{be}", platform="cpu",
                               cache=jat.AutotuneCache(tmp_path / f"j{be}.json"))
        tblocks = autotune.autotune(m, k, n, DTYPES[dt], f"cuda_{be}", platform="cpu",
                                    cache=AutotuneCache(tmp_path / f"t{be}.json"))
        assert tblocks == jblocks


def test_resolve_blocks_equals_the_reference(jat, tmp_path, monkeypatch):
    jat._DEFAULT_CACHE = None
    jat.clear_resolve_memo()
    try:
        for m, k, n in SHAPES:
            for sym in (0, 1):
                assert autotune.resolve_blocks(m, k, n, "bfloat16", "cuda_mesh",
                                               symmetry=sym, platform="cpu") == \
                    jat.resolve_blocks(m, k, n, "bfloat16", "pallas_mesh", symmetry=sym)
        assert autotune.default_cache().keys() and all(
            key.endswith("|cpu") for key in autotune.default_cache().keys())
    finally:
        jat._DEFAULT_CACHE = None
        jat.clear_resolve_memo()


def test_model_score_prefers_utilization():
    fits = model_score(4096, 4096, 4096, (512, 512, 128), torch.bfloat16)
    pads = model_score(4096 + 128, 4096, 4096, (512, 512, 128), torch.bfloat16)
    assert fits > pads


# --- cache persistence ---------------------------------------------------------


def test_cache_round_trip_and_files_read_in_the_reference(jat, cache):
    key = cache_key(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cpu")
    assert cache.get(key) is None
    cache.put(key, (256, 256, 128), source="timed", ms=1.25)
    cache.save()
    assert AutotuneCache(cache.path).get(key) == (256, 256, 128)
    raw = json.loads(cache.path.read_text())
    assert raw["version"] == CACHE_VERSION == jat.CACHE_VERSION
    assert raw["entries"][key]["source"] == "timed"
    assert jat.AutotuneCache(cache.path).get(key) == (256, 256, 128)  # the same format


def test_cache_migrates_legacy_v1_flat_dict(tmp_path):
    path = tmp_path / "legacy.json"
    legacy_key = "4096x4096x4096|bfloat16|cuda_mesh|sym0|cpu"
    path.write_text(json.dumps({legacy_key: [512, 512, 128]}))
    cache = AutotuneCache(path)
    assert cache.get(legacy_key) == (512, 512, 128)
    cache.save()  # rewritten as v2
    raw = json.loads(path.read_text())
    assert raw["version"] == CACHE_VERSION
    assert raw["entries"][legacy_key] == {"blocks": [512, 512, 128], "source": "seed",
                                          "ms": None}


def test_cache_discards_unknown_version_and_quarantines_corrupt_files(tmp_path):
    key = "512x512x512|bfloat16|cuda_mesh|sym0|cpu"
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"version": 99, "entries": {key: {"blocks": [64, 64, 64]}}}))
    assert AutotuneCache(future).get(key) is None
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        assert AutotuneCache(corrupt).get(key) is None
    assert (tmp_path / "corrupt.json.corrupt").exists() and not corrupt.exists()
    assert [e.fallback for e in ledger.events("autotune.cache_load")] == ["quarantine"]
    bad_blocks = tmp_path / "bad.json"
    bad_blocks.write_text(json.dumps({key: [512, 512]}))  # wrong arity
    assert AutotuneCache(bad_blocks).get(key) is None


# --- search --------------------------------------------------------------------


def test_cache_hit_never_searches(cache):
    key = cache_key(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda")
    cache.put(key, (256, 256, 128), source="timed")

    def explode(*a, **k):
        raise AssertionError("searched despite cache hit")

    assert autotune.autotune(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda",
                             cache=cache, measure=explode) == (256, 256, 128)


def test_timed_search_picks_fastest_records_spans_and_persists(cache):
    from repro_torch import obs

    fake_ms = {(128, 128, 128): 3.0, (256, 256, 128): 1.0}

    def measure(m, k, n, dtype, backend, blocks):
        return fake_ms.get(blocks, 10.0)

    with obs.tracing():
        got = autotune.autotune(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda",
                                cache=cache, measure=measure, max_timed=64)
    try:
        assert got == (256, 256, 128)  # mode "auto" times on the card
        spans = obs.spans("autotune.measure")
        assert len(spans) == 27 and {tuple(s.attrs["blocks"]): s.attrs["ms"]
                                     for s in spans}[(256, 256, 128)] == 1.0
    finally:
        obs.clear_spans()
    key = cache_key(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda")
    assert AutotuneCache(cache.path).get(key) == (256, 256, 128)


def test_timed_search_keeps_the_best_ranked_candidate_within_the_margin(cache):
    """A candidate faster by less than TIMED_MARGIN displaces neither the
    model's best-ranked candidate nor, measured first, the warm start; beyond
    the margin it wins."""
    ranked = candidate_blocks(512, 512, 512, torch.bfloat16, platform="cuda")
    ranked.sort(key=lambda b: model_score(512, 512, 512, b, torch.bfloat16), reverse=True)
    first, warm, later = ranked[0], ranked[5], ranked[3]
    for speedup, want in ((1 + autotune.TIMED_MARGIN / 2, first),
                          (1 + 2 * autotune.TIMED_MARGIN, later)):
        order = []

        def measure(m, k, n, dtype, backend, blocks):
            order.append(blocks)
            return 1.0 / speedup if blocks == later else 1.0

        c = AutotuneCache(cache.path.with_suffix(f".{speedup}"))
        c.put(cache_key(256, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda"), warm,
              source="timed")
        got = autotune.autotune(512, 512, 512, torch.bfloat16, "cuda_mesh", platform="cuda",
                                cache=c, measure=measure)
        assert order[0] == warm and got == want, (speedup, got)


def test_failed_candidates_are_skipped_with_ledger_records(cache):
    def measure(m, k, n, dtype, backend, blocks):
        if blocks != (128, 128, 128):
            raise RuntimeError("no such tile")
        return 2.0

    got = autotune.autotune(256, 256, 256, torch.float32, "cuda_mesh", platform="cuda",
                            cache=cache, measure=measure, max_timed=64)
    assert got == (128, 128, 128)
    assert {e.fallback for e in ledger.events("autotune.measure")} == {"skip-candidate"}


def test_warm_start_is_tried_first(cache):
    near = cache_key(1024, 1024, 1024, torch.bfloat16, "cuda_mesh", platform="cuda")
    cache.put(near, (256, 128, 128), source="timed")
    order = []

    def measure(m, k, n, dtype, backend, blocks):
        order.append(blocks)
        return 1.0

    autotune.autotune(2048, 2048, 2048, torch.bfloat16, "cuda_mesh", platform="cuda",
                      cache=cache, measure=measure)
    assert order[0] == (256, 128, 128) and len(order) == 8


def test_model_mode_on_the_cpu_runs_nothing_and_caches(cache):
    def explode(*a, **k):
        raise AssertionError("timed on the CPU")

    got = autotune.autotune(4096, 4096, 4096, torch.bfloat16, "cuda_mesh", platform="cpu",
                            cache=cache, measure=explode)
    assert all(x % 128 == 0 for x in got)
    assert cache.get(cache_key(4096, 4096, 4096, torch.bfloat16, "cuda_mesh",
                               platform="cpu")) == got


def test_measure_best_ms_times_the_call_on_the_cpu():
    calls = []
    ms = autotune.measure_best_ms(lambda x: calls.append(x), 1, warmup=2, reps=3)
    assert calls == [1] * 5 and 0 <= ms < 50


def test_ops_matmul_resolves_blocks_via_autotuner():
    from repro_torch.kernels import api
    from repro_torch.kernels.ops import matmul

    api.clear_plan_cache()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(48, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32))
    got = matmul(a, b, backend="cuda_mesh")  # no explicit blocks
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), rtol=1e-4, atol=1e-4)
    key = cache_key(48, 32, 24, torch.float32, "cuda_mesh", platform="cpu")
    assert autotune.default_cache().get(key) is not None, "autotuner was not consulted"
    assert torch.equal(matmul(a, b, backend="cuda_mesh"), got)
    api.clear_plan_cache()


def test_scrambled_backend_candidates_respect_square_grid(cache):
    for platform in ("cpu", "cuda"):
        bm, bn, bk = autotune.autotune(384, 384, 384, torch.float32, "cuda_mesh_scrambled",
                                       platform=platform, cache=cache, mode="model")
        assert 384 % bm == 0 and 384 % bn == 0 and 384 // bm == 384 // bn


# --- the card's candidate filter (shapes only) ---------------------------------

# Every main-path K1 product of the repo's models on the card: mesh-paper's
# (decode M = 4, prefill M = 128, training M = 4096, bf16 forward), the
# OLMoE / Qwen1.5-MoE dense products, the shared-expert gate (f32, N = 1)
# and the K5 group shapes resolved at their rows-per-group bound.
CARD_SHAPES = [
    (4, 2048, 2048, "bfloat16"), (4, 2048, 16384, "bfloat16"), (4, 8192, 2048, "bfloat16"),
    (4, 2048, 32768, "bfloat16"), (128, 2048, 2048, "bfloat16"),
    (128, 2048, 16384, "bfloat16"), (128, 8192, 2048, "bfloat16"),
    (4096, 2048, 2048, "bfloat16"), (4096, 8192, 2048, "bfloat16"),
    (4096, 2048, 32768, "bfloat16"), (4, 2048, 151936, "bfloat16"),
    (128, 5632, 2048, "bfloat16"), (4, 2048, 1, "float32"), (128, 2048, 1, "float32"),
    (8, 2048, 2048, "bfloat16"), (640, 1024, 2048, "bfloat16"),
]


@pytest.mark.parametrize("m,k,n,dt", CARD_SHAPES)
def test_card_candidates_never_take_a_first_simt_tile(cache, m, k, n, dt):
    cands = candidate_blocks(m, k, n, DTYPES[dt], platform="cuda")
    assert len(cands) == len(autotune._dim_candidates(m, (128, 256, 512))) * \
        len(autotune._dim_candidates(n, (128, 256, 512))) * \
        len(autotune._dim_candidates(k, (128, 256, 512)))
    want = "tc_decode" if m <= 16 and dt == "bfloat16" else (
        "tc128" if dt == "bfloat16" else "f32_128")
    for c in cands:
        kn = tmm.kernel_n(n, c[1], DTYPES[dt])
        assert tmm.tile_config(m, kn, k, *c, DTYPES[dt]) == want, c
        assert autotune.tile_smem_bytes(m, k, n, c, dt) == tmm.TILE_SMEM_BYTES[want]
    best = autotune.autotune(m, k, n, DTYPES[dt], "cuda_mesh", platform="cuda",
                             mode="model", cache=cache)
    assert best in cands


def test_card_filter_rejects_simt_blocks_and_validates_cached_entries(tmp_path):
    assert not autotune.legal_on_card(256, 2048, 2048, (32, 32, 32), "bfloat16")
    assert not autotune.legal_on_card(4, 2048, 2048, (128, 8, 128), "bfloat16")
    assert autotune.legal_on_card(4, 2048, 2048, (128, 512, 128), "bfloat16")
    # K not in 16-byte chunks: no tile but the first SIMT ones, so nothing is
    # legal and the search falls back to 128^3 as the reference does
    assert candidate_blocks(256, 100, 256, torch.bfloat16, platform="cuda") == \
        [(128, 128, 128)]
    path = tmp_path / "cuda.json"
    good = "4096x2048x2048|bfloat16|cuda_mesh|sym0|cuda"
    bad = "4096x2048x2048|float32|cuda_mesh|sym0|cuda"
    path.write_text(json.dumps({"version": 2, "entries": {
        good: {"blocks": [512, 512, 128], "source": "timed", "ms": 0.5},
        bad: {"blocks": [32, 32, 32], "source": "timed", "ms": 0.5}}}))
    with pytest.warns(UserWarning, match="quarantined 1 invalid"):
        c = AutotuneCache(path)
        assert c.get(good) == (512, 512, 128) and c.get(bad) is None
    assert [e.fallback for e in ledger.events("autotune.cache_load")] == ["retune"]


def test_grouped_tile_smem_is_k5s():
    from repro_torch.kernels import grouped

    assert autotune.tile_smem_bytes(8, 2048, 2048, (8, 512, 128), "bfloat16", grouped=True) \
        == grouped.TILE_SMEM_BYTES["tc_decode"]
    assert autotune.tile_smem_bytes(128, 2048, 2048, (128, 512, 128), "bfloat16",
                                    grouped=True) == grouped.TILE_SMEM_BYTES["tc_rows32"]


def test_tile_smem_table_matches_the_sources():
    """TILE_SMEM_BYTES is what the .cu files' constants give."""
    import re
    from pathlib import Path

    src = (Path(tmm.__file__).parent.parent / "csrc" / "mesh_matmul.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)", src)}
    tc = consts["kTcStages"] * (consts["kTcM"] * (consts["kTcK"] + 8)
                                + consts["kTcK"] * (consts["kTcN"] + 8)) * 2
    dec = consts["kDecWarps"] * consts["kDecStages"] * (
        consts["kDecM"] * (consts["kDecK"] + 8) + consts["kDecK"] * (consts["kDecN"] + 8)) * 2
    f32 = 2 * consts["kFK"] * ((consts["kFM"] + 4) + consts["kFN"]) * 4
    assert (tc, dec, f32) == (tmm.TILE_SMEM_BYTES["tc128"], tmm.TILE_SMEM_BYTES["tc_decode"],
                              tmm.TILE_SMEM_BYTES["f32_128"])
    assert tmm.TILE_SMEM_BYTES["simt64"] == (16 * (64 + 1) + 16 * 64) * 4
    assert tmm.TILE_SMEM_BYTES["simt_decode"] == (128 * (8 + 1) + 128 * 32) * 4
