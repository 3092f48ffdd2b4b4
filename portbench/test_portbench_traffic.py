"""The traffic generator: the same seed gives the same requests; every seed
gives the same sizes and gaps in another order; the prompt lengths the
warm-up covers are every length the mix can give."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.harness import traffic  # noqa: E402

MIXES = Path(__file__).resolve().parent / "traffic"


def rag():
    return json.loads((MIXES / "rag.json").read_text())


def test_same_seed_same_requests():
    a = traffic.open_loop(rag(), 152064, 2**31 + 5, 20.0)
    b = traffic.open_loop(rag(), 152064, 2**31 + 5, 20.0)
    assert [x.rid for x in a] == [x.rid for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) and x.due_s == y.due_s
               and x.max_new_tokens == y.max_new_tokens for x, y in zip(a, b))


def test_seeds_share_the_schedule_and_draw_the_tokens():
    a = traffic.open_loop(rag(), 152064, 11, 51.0)
    b = traffic.open_loop(rag(), 152064, 12, 51.0)
    assert len(a) == len(b) == round(rag()["arrivals"]["rate_per_s"] * 51.0)
    assert [(x.due_s, len(x.prompt), x.max_new_tokens) for x in a] == [
        (x.due_s, len(x.prompt), x.max_new_tokens) for x in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    gaps = np.diff([x.due_s for x in a])
    assert sorted(gaps) != list(gaps) and all(0.0 <= x.due_s < 51.0 for x in a)
    other = dict(rag(), schedule_seed=rag()["schedule_seed"] + 1)
    c = traffic.open_loop(other, 152064, 11, 51.0)
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in c)
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in c]


def test_prompt_parts_and_lengths():
    mix = rag()
    lens = traffic.prompt_lengths(mix)
    assert lens == [256 + 512 * k + 64 for k in range(2, 9)]
    reqs = traffic.open_loop(mix, 1000, 3, 30.0)
    assert {len(r.prompt) for r in reqs} == set(lens)
    shared = {tuple(r.prompt[:256]) for r in reqs}
    assert len(shared) == 1  # one system prompt for every request
    assert all(32 <= r.max_new_tokens <= 128 for r in reqs)
    assert all(r.prompt.dtype == np.int32 and r.prompt.max() < 1000 for r in reqs)


def test_batch_stream_is_seeded_and_rows_differ():
    a = traffic.first_batches(7, 3, 16, 50, "cpu", 2)
    b = traffic.first_batches(7, 3, 16, 50, "cpu", 2)
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
    assert torch.equal(a[0]["tokens"][:, 1:], a[0]["labels"][:, :-1])
    rows = torch.cat([a[0]["tokens"], a[1]["tokens"]])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_seeds_split_into_independent_streams():
    s = traffic.Seeds.of(2**31 + 99)
    assert len({s.weights, s.traffic, s.sample, s.data}) == 4
    assert traffic.Seeds.of(2**31 + 99) == s
