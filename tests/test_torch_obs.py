"""Port parity: observability (`obs/`): spans, metrics, exports, the bridge,
and the serving spans and metrics of the scheduler.

The reference's span and metric tests re-run in both packages (parametrized
`ref` / `port`); the parity tests drive the same operations through both and
compare span trees, `prometheus_text` byte for byte, histogram quantiles,
and a reduced mesh-paper served through each package's scheduler.  The
reference's in-jit guard needs `jax.core.trace_state_clean`, which this
JAX may lack, so nothing here holds the port against spans the reference
opens inside a jit; the port's own guard is held under `torch.compile`.
"""

import json
import re
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import bridge as tbridge  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.resilience import ledger as tledger  # noqa: E402

NAMES = {"pallas_mesh": "cuda_mesh", "xla": "torch", "ref": "ref"}


def _port():
    return types.SimpleNamespace(obs=tobs, bridge=tbridge, trace=ttrace, ledger=tledger,
                                 metrics_logger="repro_torch.train.metrics")


def _ref():
    pytest.importorskip("jax")
    from repro import obs
    from repro.obs import bridge, trace
    from repro.resilience import ledger

    return types.SimpleNamespace(obs=obs, bridge=bridge, trace=trace, ledger=ledger,
                                 metrics_logger="repro.train.metrics")


def _clean(pkg):
    pkg.obs.uninstall()
    pkg.obs.disable()
    pkg.obs.clear_spans()
    pkg.obs.reset_metrics()
    pkg.ledger.clear()


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    """One package's obs, fully off and empty before and after."""
    p = _ref() if request.param == "ref" else _port()
    _clean(p)
    yield p
    _clean(p)


@pytest.fixture
def both():
    """Both packages' obs, fully off and empty before and after."""
    ps = (_ref(), _port())
    for p in ps:
        _clean(p)
    yield ps
    for p in ps:
        _clean(p)


# -- span mechanics, in each package ------------------------------------------


def test_span_nesting_and_attrs(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("outer.op", a=1) as outer:
        with obs.span("inner.op") as inner:
            inner.set("found", "x")
        outer.set("late", True)
    got = {s.name: s for s in obs.spans()}
    assert set(got) == {"outer.op", "inner.op"}
    assert got["inner.op"].parent == got["outer.op"].seq
    assert got["outer.op"].parent is None
    assert got["outer.op"].attrs == {"a": 1, "late": True}
    assert got["inner.op"].attrs == {"found": "x"}
    assert got["inner.op"].duration_s <= got["outer.op"].duration_s


def test_span_records_error_and_unwinds(pkg):
    obs = pkg.obs
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("t.fail"):
            raise ValueError("boom")
    (sp,) = obs.spans("t.fail")
    assert "ValueError: boom" in sp.attrs["error"]
    with obs.span("t.after"):
        pass
    assert obs.spans("t.after")[0].parent is None


def test_traced_decorator(pkg):
    obs = pkg.obs
    calls = []

    @obs.traced("t.deco", kind="unit")
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2  # disabled: no span, function still runs
    assert obs.spans("t.deco") == []
    obs.enable()
    assert fn(2) == 3
    (sp,) = obs.spans("t.deco")
    assert sp.attrs == {"kind": "unit"}
    assert calls == [1, 2]


def test_ring_is_bounded_and_counts_drops(pkg):
    obs = pkg.obs
    obs.enable(capacity=8)
    try:
        for i in range(20):
            with obs.span("t.ring", i=i):
                pass
        st = obs.stats()
        assert st["retained"] == 8 and st["dropped"] == 12
        assert [s.attrs["i"] for s in obs.spans("t.ring")] == list(range(12, 20))
    finally:
        obs.configure(capacity=pkg.trace.DEFAULT_CAPACITY)


def test_threads_get_independent_stacks(pkg):
    obs = pkg.obs
    obs.enable()
    errs = []

    def worker(k):
        try:
            for i in range(50):
                with obs.span(f"t.outer{k}"):
                    with obs.span(f"t.inner{k}", i=i):
                        pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in threads)
    assert obs.stats()["finished"] == 4 * 50 * 2
    for k in range(4):
        inners = obs.spans(f"t.inner{k}")
        outers = {s.seq: s for s in obs.spans(f"t.outer{k}")}
        assert len(inners) == 50
        for sp in inners:
            assert sp.parent in outers and outers[sp.parent].tid == sp.tid


def test_tracing_scope_restores_prior_state(pkg):
    obs = pkg.obs
    assert not obs.is_enabled()
    with obs.tracing():
        assert obs.is_enabled()
        with obs.span("t.scoped"):
            pass
    assert not obs.is_enabled()
    assert len(obs.spans("t.scoped")) == 1


# -- metrics and exports, in each package -------------------------------------


def test_counter_gauge_histogram_basics(pkg):
    obs = pkg.obs
    c = obs.counter("t_total", "help", labels=("site",))
    c.inc(site="a"), c.inc(2, site="a"), c.inc(site="b")
    assert c.value(site="a") == 3 and c.total() == 4
    with pytest.raises(ValueError):
        c.inc(-1, site="a")
    with pytest.raises(ValueError):
        c.inc(site="a", extra="x")  # undeclared label
    g = obs.gauge("t_gauge")
    g.set(5), g.inc(-2)
    assert g.value() == 3
    h = obs.histogram("t_lat_seconds")
    for v in (1e-5, 1e-5, 1e-3, 0.1):
        h.observe(v)
    assert h.count() == 4 and h.sum() == pytest.approx(0.10102)
    assert 1e-6 < h.quantile(0.5) < 1e-3
    assert h.quantile(1.0) >= 0.05


def test_registry_is_idempotent_and_kind_checked(pkg):
    obs = pkg.obs
    a = obs.counter("t_same", labels=("x",))
    assert obs.counter("t_same", labels=("x",)) is a
    with pytest.raises(TypeError):
        obs.gauge("t_same", labels=("x",))
    with pytest.raises(TypeError):
        obs.counter("t_same", labels=("y",))


def test_chrome_trace_schema(pkg, tmp_path):
    obs = pkg.obs
    obs.enable()
    with obs.span("outer.op", k="v"):
        with obs.span("inner.op"):
            pass
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(str(path), metadata={"run": "test"})
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer.op", "inner.op"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert e["cat"] == e["name"].split(".")[0]
        assert isinstance(e["args"]["seq"], int)
    inner = next(e for e in xs if e["name"] == "inner.op")
    outer = next(e for e in xs if e["name"] == "outer.op")
    assert inner["args"]["parent"] == outer["args"]["seq"]
    assert doc["otherData"]["run"] == "test"


_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? ([0-9.e+-]+|\+Inf))$"
)


def test_prometheus_text_format(pkg):
    obs = pkg.obs
    obs.counter("t_req_total", "requests", labels=("status",)).inc(status="ok")
    h = obs.histogram("t_dur_seconds", "durations")
    h.observe(0.001), h.observe(0.5)
    text = obs.prometheus_text()
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line), f"malformed exposition line: {line!r}"
    assert 't_req_total{status="ok"} 1' in text
    bucket_vals = [
        float(m.group(1))
        for m in re.finditer(r't_dur_seconds_bucket\{le="[^"]+"\} (\S+)', text)
    ]
    assert bucket_vals == sorted(bucket_vals)
    count = float(re.search(r"t_dur_seconds_count (\S+)", text).group(1))
    assert bucket_vals[-1] == count == 2


def test_jsonl_sink_and_metrics_logger_own_their_handles(pkg, tmp_path):
    import importlib

    path = tmp_path / "m.jsonl"
    with pkg.obs.JsonlSink(str(path)) as sink:
        sink.write({"a": 1})
        assert not sink.closed
    assert sink.closed
    with pytest.raises(ValueError):
        sink.write({"b": 2})
    assert json.loads(path.read_text()) == {"a": 1}
    MetricsLogger = importlib.import_module(pkg.metrics_logger).MetricsLogger
    path = tmp_path / "train.jsonl"
    with MetricsLogger(str(path)) as lg:
        lg.log(1, {"loss": 2.5})
        lg.summary({"final_step": 1})
        assert not lg.closed
    assert lg.closed
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert recs[0]["step"] == 1 and recs[0]["loss"] == 2.5
    assert recs[1] == {"summary": {"final_step": 1}}


def test_train_metrics_writes_through_the_obs_sink():
    from repro_torch.train import metrics

    assert metrics.JsonlSink is tobs.JsonlSink


# -- the bridge, in each package ----------------------------------------------


def test_ledger_events_mirror_to_counter_exactly(pkg):
    ledger, obs = pkg.ledger, pkg.obs
    ledger.record("t.site_a", cause="ValueError: x", fallback="skip")
    ledger.record("t.site_a", cause="ValueError: y", fallback="skip")
    obs.install()  # backfills the two pre-install events
    obs.install()  # idempotent: no double subscription
    ledger.record("t.site_b", cause="KeyError: z", fallback="retry")
    c = pkg.bridge.degradation_counter()
    assert c.total() == ledger.count() == 3
    assert c.value(site="t.site_a", cause="ValueError") == 2
    assert c.value(site="t.site_b", cause="KeyError") == 1
    per_site = {}
    for (site, _), v in c.series().items():
        per_site[site] = per_site.get(site, 0) + v
    assert per_site == {s: sum(d.values()) for s, d in ledger.summary().items()}


def test_flush_of_invalid_records_never_raises(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "cal.json"))
    pkg.obs.submit_calibration([{"terms": "not-a-dict", "ms": -1}])
    assert pkg.obs.flush_calibration() == 0  # invalid batch: dropped, no raise
    assert pkg.obs.pending_calibration_records() == []


# -- parity: the same operations through both packages ------------------------


def _drive(obs):
    """Spans and metrics of one scripted run (attributes of every JSON type)."""
    obs.enable()
    with obs.span("serve.tick", tick=1, active=2, queued=0):
        with obs.span("serve.prefill", rid="r0", tokens=8) as sp:
            sp.set("blocks", [128, 512, 128])
        for i in range(2):
            with obs.span("serve.decode", slots=2, tick=1):
                with obs.span("plan.execute", backend="x", key=f"4x64x64|x", flag=bool(i)):
                    pass
    with pytest.raises(KeyError):
        with obs.span("t.fail", ratio=0.5):
            raise KeyError("k")
    obs.counter("serve_requests_total", "request outcomes by status",
                labels=("status",)).inc(status="served")
    obs.counter("serve_requests_total", "request outcomes by status",
                labels=("status",)).inc(3, status="shed")
    obs.gauge("t_inflight", "in flight").set(2.5)
    h = obs.histogram("serve_tpot_seconds", "per-tick decode wall time (time per token)")
    for v in (3e-6, 1.5e-4, 2e-4, 2e-4, 0.012, 0.75, 300.0):
        h.observe(v)
    obs.histogram("t_lat_seconds", "labelled", labels=("op",)).observe(0.25, op="a")


def _tree(obs):
    return [(s.name, s.seq, s.parent, s.attrs) for s in obs.spans()]


def test_span_tree_and_prometheus_text_equal_the_reference(both):
    ref, port = both
    _drive(ref.obs)
    _drive(port.obs)
    assert _tree(port.obs) == _tree(ref.obs)
    assert port.obs.prometheus_text() == ref.obs.prometheus_text()
    assert port.obs.snapshot() == ref.obs.snapshot()
    assert [s.as_dict().keys() for s in port.obs.spans()] == \
        [s.as_dict().keys() for s in ref.obs.spans()]
    assert port.obs.stats() == ref.obs.stats()


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_equal_the_reference(both, q):
    rng = np.random.default_rng(int(q * 100))
    values = np.exp(rng.uniform(np.log(1e-7), np.log(500.0), size=257)).tolist()
    got = []
    for p in both:
        h = p.obs.histogram("t_q_seconds")
        assert h.quantile(q) is None  # empty series
        for v in values:
            h.observe(v)
        got.append((h.quantile(q), h.count(), h.sum(), h.series()))
    assert got[0] == got[1]
    assert tobs.LATENCY_BUCKETS_S == _ref().obs.LATENCY_BUCKETS_S


def test_plan_execute_spans_feed_calibration(both, tmp_path, monkeypatch):
    """Warm `plan.execute` spans become calibration records in both
    packages, with the same terms (backend names mapped); the first
    execution of a plan is discarded."""
    import importlib

    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro_torch.kernels import api

    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "cal.json"))
    tcal = importlib.import_module("repro_torch.costmodel.calibrate")
    tcal.clear_coefficients_memo()
    ref, port = both
    a = np.ones((16, 16), np.float32)
    pend = {}
    for p, mod, x in ((ref, japi, jnp.asarray(a)), (port, api, torch.from_numpy(a))):
        p.obs.enable()
        p.obs.install()
        pl = mod.plan(mod.GemmSpec.from_operands(x, x, blocks=(16, 16, 16)))
        np.asarray(pl(x, x))  # first execution: discarded
        np.asarray(pl(x, x))  # warm: a calibration record
        pend[p is port] = p.obs.pending_calibration_records()
    (jrec,), (trec,) = pend[False], pend[True]
    assert trec["source"] == "obs" and trec["ms"] > 0
    jterms = dict(jrec["terms"], backend=NAMES[jrec["terms"]["backend"]])
    assert trec["terms"] == jterms and trec["terms"]["flops"] == 2 * 16**3
    assert trec["key"] == "16x16x16|torch"
    assert port.obs.flush_calibration(refit=False) == 1
    assert port.obs.pending_calibration_records() == []
    recs = tcal.CalibrationCache(str(tmp_path / "cal.json")).records("cpu")
    assert len(recs) == 1 and recs[0]["source"] == "obs"
    assert port.obs.calibration_stamp()["cache_path"] == str(tmp_path / "cal.json")
    tcal.clear_coefficients_memo()


# -- the port's own contracts -------------------------------------------------


def test_disabled_path_is_one_attribute_check():
    """With tracing off, `span()` returns the shared no-op after reading
    `_STATE.enabled`, and a plan's execution opens no span."""
    from repro_torch.kernels import api

    assert not tobs.is_enabled()
    assert tobs.span("t.off", a=1) is ttrace._NULL
    a = torch.ones(8, 8)
    p = api.plan(api.GemmSpec.from_operands(a, a, blocks=(8, 8, 8)), backend="torch",
                 device="cpu")
    p(a, a)
    p.dispatch(a, a).block()
    assert tobs.stats()["started"] == 0 and p._obs_attrs_cache is None

    def workload():
        return sum(range(5000))

    def timed(fn, iters=2_000):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return time.perf_counter() - t0

    def spans_only():
        with tobs.span("t.overhead", i=0):
            pass

    per_call = min(timed(spans_only) for _ in range(3))
    body = min(timed(workload) for _ in range(3))
    assert per_call / body < 0.02, (per_call, body)


def test_no_span_inside_torch_compile():
    """The trace-aware guard: a span opened while dynamo traces is
    suppressed and counted; the compiled function still runs."""
    tobs.enable()
    try:
        @torch.compile(backend="eager", fullgraph=False)
        def f(x):
            with tobs.span("t.in_compile"):
                return x * 2

        np.testing.assert_allclose(f(torch.ones(4)).numpy(), 2.0)
        assert tobs.spans("t.in_compile") == []
        assert tobs.stats()["suppressed_in_trace"] >= 1
    finally:
        tobs.disable()
        tobs.clear_spans()


def test_plan_spans_carry_the_reference_attributes(both):
    """plan.build, plan.execute and plan.dispatch: the reference's names and
    attributes (backend names mapped), `terms` included."""
    import jax.numpy as jnp

    from repro.kernels import api as japi
    from repro_torch.kernels import api

    ref, port = both
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    got = {}
    for p, mod, x in ((ref, japi, jnp.asarray(a)), (port, api, torch.from_numpy(a))):
        p.obs.enable()
        pl = mod.plan(mod.GemmSpec.from_operands(x, x, blocks=(8, 8, 8)),
                      backend="pallas_mesh" if mod is japi else "cuda_mesh")
        pl.dispatch(x, x).block()
        np.asarray(pl(x, x))
        got[p is port] = [(s.name, s.parent, s.attrs) for s in p.obs.spans()]

    def mapped(attrs):
        out = dict(attrs)
        for k in ("backend", "built_backend"):
            if k in out:
                out[k] = NAMES[out[k]]
        if "key" in out:
            head, be = out["key"].rsplit("|", 1)
            out["key"] = f"{head}|{NAMES[be]}"
        if "terms" in out:
            out["terms"] = dict(out["terms"], backend=NAMES[out["terms"]["backend"]])
        return out

    want = [(n, par, mapped(at)) for n, par, at in got[False]]
    assert [n for n, _, _ in got[True]] == ["plan.build", "plan.dispatch", "plan.execute"]
    assert got[True] == want


# -- the scheduler: reduced mesh-paper served with tracing on -----------------


def _serve_reduced(obs, get_config, get_model, sched, init, **server_kw):
    """Reduced mesh-paper through one package's scheduler, traced, with the
    bridge installed: 3 requests of 8-token prompts x 4 tokens on 2 slots.
    Returns the span counts by name, the metrics snapshot and the server's
    counters."""
    cfg = get_config("mesh-paper").reduced()
    model = get_model(cfg)
    scfg = sched.ServeConfig(max_slots=2, page_size=8, num_pages=1 + 2 * 4,
                             max_pages_per_seq=4, queue_capacity=8, warmup_prompt_lens=(8,))
    server = sched.ContinuousBatchingServer(model, init(model), scfg, **server_kw)
    obs.enable()
    obs.install()
    server.warmup()
    for r in range(3):
        server.submit(sched.Request(rid=f"r{r}", prompt=np.zeros(8, np.int32),
                                    max_new_tokens=4))
    server.drain()
    counts = {}
    for s in obs.spans():
        counts[s.name] = counts.get(s.name, 0) + 1
    return counts, obs.snapshot(), dict(server.counters)


def test_scheduler_spans_and_metrics_equal_the_reference(both, tmp_path, monkeypatch):
    import jax

    from repro.configs import get_config as jget_config
    from repro.launch import scheduler as jsched
    from repro.models import get_model as jget_model
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import scheduler as tsched
    from repro_torch.models import get_model

    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "cal.json"))
    ref, port = both
    jparams = {}

    def jinit(model):
        jparams["p"] = model.init(jax.random.PRNGKey(0))
        return jparams["p"]

    def tinit(model):
        return params_from_numpy(jax.tree.map(np.asarray, jparams["p"]), "cpu")

    jc, jm, jcount = _serve_reduced(ref.obs, jget_config, jget_model, jsched, jinit)
    tc, tm, tcount = _serve_reduced(port.obs, get_config, get_model, tsched, tinit,
                                    device="cpu")
    # Spans the reference opens outside its jitted steps: the same counts.
    for name in ("serve.tick", "serve.prefill", "serve.decode", "plan.dispatch"):
        assert tc.get(name, 0) == jc.get(name, 0) > 0, name
    assert tcount["ticks"] == jcount["ticks"] and tcount["served"] == jcount["served"] == 3
    # The port runs eagerly: one plan.execute per GEMM execution (the
    # reference's run inside its jitted steps), the canary's included.
    layers = get_config("mesh-paper").reduced().num_layers
    gemms = 6 * layers + 1  # q, k, v, o, mlp wi, mlp wo per layer; lm_head
    steps = tcount["prefills"] + tcount["decode_steps"]
    assert tc["plan.execute"] == gemms * steps + 1
    assert tc["calibrate.ingest"] == 1  # drain flushed the bridge
    # Counters and histogram counts equal the reference's.
    for name in ("serve_requests_total", "serve_admitted_total", "serve_ticks_total",
                 "serve_decode_tokens_total"):
        assert tm[name] == jm[name], name
    for name in ("serve_ttft_seconds", "serve_tpot_seconds"):
        assert tm[name]["series"][""]["count"] == jm[name]["series"][""]["count"] > 0


def test_serve_main_obs_export_end_to_end(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "cal.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    out = tmp_path / "trace.json"
    try:
        serve.main([
            "--arch", "mesh-paper", "--reduced", "--device", "cpu", "--batch", "1",
            "--prompt-len", "8", "--gen", "2", "--requests", "2",
            "--plan-stats", "--obs-export", str(out),
        ])
        text = capsys.readouterr().out
        assert "obs export:" in text and "pred=" in text and "obs[n=" in text
        doc = json.loads(out.read_text())
        names = [e["name"] for e in doc["traceEvents"]]
        assert names.count("serve.request") == 2 and "plan.execute" in names
        assert "source" in doc["otherData"]["calibration"]
        (tmp_path / "trace.json.prom").read_text()
        lines = (tmp_path / "trace.json.jsonl").read_text().splitlines()
        assert lines and all(json.loads(x)["name"] for x in lines)
    finally:
        _clean(_port())
