"""The scheduler's span tree, on the CPU at the reduced sizes.

Every part of a tick is a named span or the tick's own bookkeeping: a
`serve.prefill` runs from admission to its first token on the host and
holds one `.launch`, one `.scatter` and one `.read`; a `serve.decode`
holds one `.launch` and one `.read`; the `serve.retire` after it holds the
retirement of the requests that finished.  With tracing off a tick starts
no span.
"""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

# (architecture, server settings): a roomy pool; a pool whose growth must
# preempt (two sequences of 3 pages each grow to 4 in 7 pages); the
# stacked-state family, whose prefill inserts its state into the slot.
CASES = {
    "paged": ("mesh-paper", dict(max_slots=2, page_size=4, num_pages=1 + 2 * 5,
                                 max_pages_per_seq=5)),
    "paged_preempt": ("mesh-paper", dict(max_slots=2, page_size=4, num_pages=1 + 7,
                                         max_pages_per_seq=5)),
    "stacked": ("rwkv6-1.6b", dict(max_slots=2)),
}


@pytest.fixture()
def tracer():
    obs.disable()
    obs.clear_spans()
    yield
    obs.disable()
    obs.clear_spans()


def _server(case):
    arch, kw = CASES[case]
    model = get_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    scfg = ServeConfig(queue_capacity=8, warmup_prompt_lens=(8,), **kw)
    server = ContinuousBatchingServer(model, params, scfg, device="cpu")
    server.warmup()
    return server


def _requests(n=3, gen=6):
    rng = np.random.default_rng(5)
    return [Request(rid=f"r{i}", prompt=rng.integers(0, 64, 8).astype(np.int32),
                    max_new_tokens=gen) for i in range(n)]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.seq]


def _one_each(spans, parent, names):
    kids = _children(spans, parent)
    assert sorted(k.name for k in kids) == sorted(names), (parent, kids)
    for k in kids:
        assert parent.t0 <= k.t0 <= k.t1 <= parent.t1, (parent, k)
    return {k.name: k for k in kids}


@pytest.mark.parametrize("case", list(CASES))
def test_span_tree_of_a_traced_run(tracer, case):
    server = _server(case)
    freed_at = []
    if server.alloc is not None:
        free = server.alloc.free

        def timed(pages):
            freed_at.append(time.monotonic())
            return free(pages)

        server.alloc.free = timed
    obs.enable()
    for r in _requests():
        server.submit(r)
    server.drain()
    obs.disable()
    spans = obs.spans()
    assert obs.stats()["dropped"] == 0
    by_seq = {s.seq: s for s in spans}

    prefills = [s for s in spans if s.name == "serve.prefill"]
    assert len(prefills) == server.counters["prefills"] - len(server.cfg.warmup_prompt_lens)
    assert {p.attrs["rid"] for p in prefills} == {"r0", "r1", "r2"}
    for p in prefills:
        assert by_seq[p.parent].name == "serve.tick"
        kids = _one_each(spans, p, ["serve.prefill.launch", "serve.prefill.scatter",
                                    "serve.prefill.read"])
        assert kids["serve.prefill.launch"].t1 <= kids["serve.prefill.scatter"].t0
        assert kids["serve.prefill.scatter"].t1 <= kids["serve.prefill.read"].t0

    decodes = [s for s in spans if s.name == "serve.decode"]
    assert len(decodes) == server.counters["decode_steps"] - 1  # the warm-up's step
    for d in decodes:
        assert by_seq[d.parent].name == "serve.tick"
        kids = _one_each(spans, d, ["serve.decode.launch", "serve.decode.read"])
        assert kids["serve.decode.launch"].t1 <= kids["serve.decode.read"].t0

    # one retirement after each decode step, in the same tick
    retires = [s for s in spans if s.name == "serve.retire"]
    assert [by_seq[r.parent].t0 for r in retires] == [by_seq[d.parent].t0 for d in decodes]
    for d, r in zip(decodes, retires):
        assert d.t1 <= r.t0 and not _children(spans, r)
    # a request that finished frees its pages inside a retirement; a
    # preempted one frees them while its tick grows another's
    statuses = [r.status for r in server.results.values()]
    assert ("preempted" in statuses) == (case == "paged_preempt")
    if server.alloc is not None:
        retired = [t for t in freed_at if any(r.t0 <= t <= r.t1 for r in retires)]
        assert len(retired) == statuses.count("ok") > 0
        assert len(freed_at) == len(statuses)


@pytest.mark.parametrize("case", ["paged", "stacked"])
def test_untraced_tick_starts_no_span(tracer, case):
    server = _server(case)
    for r in _requests():
        server.submit(r)
    before = obs.stats()["started"]
    server.drain()
    assert server.counters["served"] == 3
    assert obs.stats()["started"] == before


def test_spans_leave_the_served_tokens_alone(tracer):
    """The same requests give the same tokens traced and untraced."""
    got = {}
    for traced in (False, True):
        server = _server("paged")
        if traced:
            obs.enable()
        res = server.run([dataclasses.replace(r, arrival=i) for i, r in enumerate(_requests())])
        obs.disable()
        got[traced] = {rid: r.tokens for rid, r in res.items()}
    assert got[True] == got[False]
