"""The readers of the scheduler's spans: hand-made runs whose numbers are
worked out by hand, the device readers silent off the card and on an empty
profile, and a traced run at the port's tiny size on the CPU."""

import time

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import busy, spec  # noqa: E402
from portbench.harness.record import RunRecord  # noqa: E402
from portbench.harness.trace import Profile, SpanRec  # noqa: E402
from portbench.run import run_cell  # noqa: E402
from portbench.test_portbench_run import make_root  # noqa: E402

PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12, "source": "test"}


def reader(name):
    return spec.metric_reader(name)


def record(spans, ops=None, window=(0.0, 10.0), peaks=PEAKS, profiled=(0.0, 10.0)):
    profile = None if ops is None else Profile(t0=profiled[0], t1=profiled[1],
                                               ops=sorted(ops, key=lambda o: o[1]), busy_s=0.0)
    return RunRecord(cfg=None, cell=None, peaks=peaks, profile=profile,
                     spans=[SpanRec(n, t0, t1, a) for n, t0, t1, a in spans], window=window)


def prefill(t0, t1, read=True):
    """A `serve.prefill` and, as the scheduler opens them, its read at its end."""
    out = [("serve.prefill", t0, t1, {"rid": f"r{t0}", "tokens": 8})]
    if read:
        out.append(("serve.prefill.read", t1 - 0.01, t1, {}))
    return out


def test_prefill_ms_p90_is_the_nearest_rank_in_the_window():
    # ten admissions in the window of 0.1 .. 1.0 s, one after it of 5 s
    spans = [s for k in range(1, 11) for s in prefill(k * 0.5, k * 0.5 + 0.1 * k)]
    spans += prefill(11.0, 16.0)
    assert reader("prefill_ms_p90.serve").read(record(spans)) == pytest.approx(900.0)
    # a program whose prefill span closes before its token's read: nothing
    bare = [s for k in range(1, 11) for s in prefill(k * 0.5, k * 0.5 + 0.1, read=False)]
    assert reader("prefill_ms_p90.serve").read(record(bare)) is None


def test_decode_launch_ms_p50_is_the_median_in_the_window():
    spans = [("serve.decode.launch", t, t + d, {})
             for t, d in ((1.0, 0.001), (2.0, 0.004), (3.0, 0.002), (4.0, 0.003),
                          (12.0, 0.1))]
    assert reader("decode_launch_ms_p50.serve").read(record(spans)) == pytest.approx(2.5)
    assert reader("decode_launch_ms_p50.serve").read(record([])) is None


PAGEABLE, PINNED = "Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pinned)"
DECODES = [("serve.decode", 1.0, 2.0, {"slots": 2, "tick": 1}),
           ("serve.decode.read", 1.85, 2.0, {}),
           ("serve.decode", 3.0, 4.0, {"slots": 2, "tick": 2}),
           ("serve.decode.read", 3.9, 4.0, {}),
           ("serve.decode", 5.0, 6.0, {"slots": 2, "tick": 3}),
           ("serve.decode.read", 5.9, 6.0, {}),
           ("serve.decode", 9.5, 10.5, {"slots": 2, "tick": 4})]  # ends past the profile
OPS = [("k", 0.5, 1.25),  # 0.25 s inside the first step
       ("k", 1.5, 1.75), ("k", 1.6, 1.8),  # overlapping: 0.3 s
       (PAGEABLE, 1.9, 1.95),  # 0.05 s, 50 ms before the close
       ("k", 3.2, 3.6), ("k", 3.5, 4.5),  # 0.8 s of the second step
       (PAGEABLE, 3.95, 4.005),  # ends 5 ms after the close: within 1 % of the step
       ("k", 5.0, 6.0),  # the whole third step, left out:
       (PAGEABLE, 5.95, 6.02),  # its copy ends 20 ms after the close
       ("k", 9.6, 9.9)]  # inside a step the profile does not hold whole


def test_decode_busy_clips_the_union_to_whole_checked_steps(capsys):
    got = reader("decode_busy.serve").read(record(DECODES, OPS))
    assert got == pytest.approx(100.0 * (0.6 + 0.8) / 2.0)
    err = capsys.readouterr().err
    assert "[decode_busy.serve] 2 profiled serve.decode spans kept, 1 left out" in err
    assert "clock check over 3 profiled decode reads" in err
    assert "smallest lead from the copy's end to the read's close -20000.0 us" in err
    assert "largest head start of the copy before the read -50000.0 us" in err


@pytest.mark.parametrize("copy,kept", [
    ((0.95, 0.96), True),
    ((0.895, 0.9), True),  # starts 5 ms before the read opens: within 10 ms
    ((0.885, 0.89), False),  # 15 ms before
    ((1.0, 1.009), True),
    ((1.0, 1.011), False),  # ends 11 ms after the read closes
    (None, False),  # no device-to-host copy
])
def test_a_step_is_kept_where_its_copy_lies_in_its_read(copy, kept):
    spans = [SpanRec("serve.decode", 0.0, 1.0, {}), SpanRec("serve.decode.read", 0.9, 1.0, {}),
             SpanRec("serve.decode", 1.5, 2.0, {})]  # no read: left out
    ops = [("k", 0.1, 0.2)] + ([(PAGEABLE, *copy)] if copy else [])
    profile = Profile(t0=0.0, t1=3.0, ops=sorted(ops, key=lambda o: o[1]), busy_s=0.0)
    got, left_out = busy.checked(profile, spans, "serve.decode")
    assert [s.t0 for s in got] == ([0.0] if kept else [])
    assert left_out == (1 if kept else 2)


def test_clock_check_pairs_each_read_with_its_nearest_copy(capsys):
    spans = [("serve.decode", 0.5, 1.1, {}), ("serve.decode.read", 1.0, 1.1, {}),
             ("serve.decode", 1.5, 2.1, {}), ("serve.decode.read", 2.0, 2.1, {})]
    ops = [("k", 0.6, 0.9),
           (PAGEABLE, 0.97, 0.98),  # 30 ms before its read opens
           (PINNED, 1.2, 1.3),  # another read's copy, farther from both
           (PAGEABLE, 2.05, 2.06)]  # 40 ms before its read closes
    reader("decode_busy.serve").read(record(spans, ops))
    err = capsys.readouterr().err
    assert "smallest lead from the copy's end to the read's close 40000.0 us" in err
    assert "largest head start of the copy before the read 30000.0 us" in err
    assert "1 profiled serve.decode spans kept, 1 left out" in err


def test_prefill_busy_reads_whole_checked_prefills(capsys):
    spans = prefill(1.0, 2.0) + prefill(3.0, 3.5) + prefill(5.0, 5.5) + prefill(9.8, 10.2)
    ops = [("k", 0.0, 1.5), ("k", 1.9, 3.2), (PINNED, 1.995, 1.996), ("k", 3.25, 3.3),
           (PINNED, 3.495, 3.496),  # 1 ms of busy card
           ("k", 5.0, 5.5), (PINNED, 5.52, 5.53),  # 30 ms late: left out
           ("k", 9.9, 10.0)]
    got = reader("prefill_busy.serve").read(record(spans, ops))
    assert got == pytest.approx(100.0 * (0.5 + 0.1 + 0.2 + 0.05 + 0.001) / 1.5)
    assert "[prefill_busy.serve] 2 profiled serve.prefill spans kept, 1 left out" in (
        capsys.readouterr().err)
    bare = prefill(1.0, 2.0, read=False)
    assert reader("prefill_busy.serve").read(record(bare, ops)) is None


@pytest.mark.parametrize("name", ["decode_busy.serve", "prefill_busy.serve"])
def test_device_readers_are_silent_off_the_card_and_on_an_empty_profile(name):
    spans = DECODES + prefill(5.0, 6.0)
    assert reader(name).read(record(spans, OPS, peaks=None)) is None
    assert reader(name).read(record(spans, [])) is None
    assert reader(name).read(record(spans, None)) is None


def test_traced_tiny_run_prints_the_span_metrics(tmp_path):
    root = make_root(tmp_path)
    got = run_cell("t.serve", 2**31 + 11, 1.5, True, root=root, device="cpu", reduced=True,
                   t_start=time.monotonic())
    assert got["correct"] is True
    m = got["metrics"]
    assert m["prefill_ms_p90.serve"]["unit"] == "ms" and m["prefill_ms_p90.serve"]["value"] > 0
    assert m["decode_launch_ms_p50.serve"]["value"] > 0
    # each launch is a part of its decode step
    assert m["decode_launch_ms_p50.serve"]["value"] <= m["decode_tick_ms_p50.serve"]["value"]
    assert "decode_busy.serve" not in m and "prefill_busy.serve" not in m  # no device here
    names = {s.name for s in got["_extra"]["record"].spans}
    assert {"serve.prefill.launch", "serve.prefill.scatter", "serve.prefill.read",
            "serve.decode.launch", "serve.decode.read", "serve.retire"} <= names
