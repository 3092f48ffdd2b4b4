"""The one traffic generator: every mix is a data file it reads
(`portbench/traffic/<mix>.json`).

Serving mixes (`"kind": "serve"`) are open loop.  A run of W seconds at
`rate_per_s` is due round(rate·W) requests.  The schedule is the mix's:
the gaps are the exponential distribution's quantiles at (i + 0.5) / N
(so the arrivals are as bursty as Poisson arrivals at that rate), each
prompt part's counts cycle evenly over their range, and the answer
lengths are spread evenly over theirs, each list in an order drawn from
the mix's `schedule_seed`.  The run's seed draws every token id (and the
weights).  So every seed does the same work at the same times: a 90th
percentile over some 80 requests follows where the long prompts fall,
and with an order drawn per seed it moved by up to 30 % between seeds
where two runs of one seed moved by under 5 %.

A prompt is a list of parts: `shared` (the same tokens in every request,
such as a system prompt), `corpus` (`count` distinct passages drawn from
a corpus of `corpus_size` passages made from the seed) and `distinct`
(fresh tokens per request, such as a question).

Training mixes (`"kind": "train"`) are closed loop: a stream of batches
of random token rows of `seq_len` + 1 tokens, made on the device from the
seed, so every row differs; the labels are the rows shifted by one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Seeds:
    """Independent streams drawn from one run seed."""

    weights: int
    traffic: int
    sample: int
    data: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        kids = np.random.SeedSequence(seed).spawn(4)
        return cls(*(int(k.generate_state(1, np.uint64)[0] >> np.uint64(1)) for k in kids))


@dataclasses.dataclass(frozen=True)
class Arrival:
    rid: str
    due_s: float  # seconds after the window opens
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n values spread evenly over [lo, hi] (ends included)."""
    if n == 1:
        return np.array([(lo + hi) // 2])
    return np.rint(lo + (hi - lo) * np.arange(n) / (n - 1)).astype(np.int64)


def _cycle(lo: int, hi: int, n: int) -> np.ndarray:
    """lo..hi repeated until n values: each value as often as the others, within one."""
    return lo + np.arange(n) % (hi - lo + 1)


def prompt_lengths(mix: Dict[str, Any]) -> List[int]:
    """Every prompt length the mix can produce, ascending."""
    lens = [0]
    for part in mix["prompt"]:
        if part["part"] == "corpus":
            lo, hi = part["count"]
            lens = [x + c * part["tokens"] for x in lens for c in range(lo, hi + 1)]
        else:
            lens = [x + part["tokens"] for x in lens]
    return sorted(set(lens))


def longest_request(mix: Dict[str, Any]) -> int:
    """Prompt plus answer tokens of the mix's longest request."""
    return prompt_lengths(mix)[-1] + mix["answer_tokens"][1]


def open_loop(mix: Dict[str, Any], vocab: int, seed: int, seconds: float) -> List[Arrival]:
    """The requests due in a window of `seconds`, in due order."""
    rng = np.random.default_rng(seed)
    order = np.random.default_rng(mix["schedule_seed"])
    rate = float(mix["arrivals"]["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = order.permutation(gaps)
    due = np.cumsum(gaps) - gaps[0]
    due *= seconds * (n - 0.5) / n / max(float(due[-1]), 1e-9) if n > 1 else 0.0
    answers = order.permutation(_spread(*mix["answer_tokens"], n))
    parts = []
    for part in mix["prompt"]:
        t = part["tokens"]
        if part["part"] == "shared":
            toks = rng.integers(0, vocab, t, dtype=np.int32)
            parts.append(lambda i, toks=toks: [toks])
        elif part["part"] == "corpus":
            corpus = rng.integers(0, vocab, (part["corpus_size"], t), dtype=np.int32)
            counts = order.permutation(_cycle(*part["count"], n))
            picks = [rng.choice(part["corpus_size"], int(c), replace=False) for c in counts]
            parts.append(lambda i, corpus=corpus, picks=picks: [corpus[j] for j in picks[i]])
        elif part["part"] == "distinct":
            fresh = rng.integers(0, vocab, (n, t), dtype=np.int32)
            parts.append(lambda i, fresh=fresh: [fresh[i]])
        else:
            raise ValueError(f"unknown prompt part {part['part']!r}")
    out = []
    for i in range(n):
        prompt = np.concatenate([seg for make in parts for seg in make(i)]).astype(np.int32)
        out.append(Arrival(rid=f"r{i:05d}", due_s=float(due[i]), prompt=prompt,
                           max_new_tokens=int(answers[i])))
    return out


class BatchStream:
    """Training batches on the device: rows of seq_len + 1 random tokens
    from a generator seeded once, split into tokens and next-token labels."""

    def __init__(self, seed: int, rows: int, seq_len: int, vocab: int, device):
        self.rows, self.seq_len, self.vocab = rows, seq_len, vocab
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def next(self) -> Dict[str, torch.Tensor]:
        x = torch.randint(0, self.vocab, (self.rows, self.seq_len + 1), generator=self.gen,
                          device=self.device, dtype=torch.int64).to(torch.int32)
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def first_batches(seed: int, rows: int, seq_len: int, vocab: int, device, n: int
                  ) -> Sequence[Dict[str, torch.Tensor]]:
    """The first n batches of the stream `BatchStream(seed, ...)` gives."""
    stream = BatchStream(seed, rows, seq_len, vocab, device)
    return [stream.next() for _ in range(n)]
