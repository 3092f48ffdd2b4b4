"""Deterministic, resumable, host-sharded data pipeline (port of
`repro.data.pipeline`, numpy only: the port keeps its own copy so that it
imports nothing of the reference; batches equal the reference's bit for bit).

Synthetic corpus (offline container): a seeded Markov-ish token stream that is
a pure function of (seed, step, host_shard) — so
  * any host can regenerate exactly its shard (host-sharded loading),
  * restoring a checkpoint and re-seeking to `step` reproduces the stream
    bit-exactly (resumable iterator state == a single integer),
  * straggler-failover can reassign shards deterministically.

`SyntheticLM` yields {"tokens", "labels"} with labels = next-token targets;
`pack_documents` packs variable-length documents into rows with segment ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "pack_documents"]


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")


class SyntheticLM:
    """Deterministic synthetic LM batches; state is just `self.step`."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def state(self) -> int:
        return self.step

    def restore(self, step: int) -> None:
        self.step = step

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        # Per-(step, host) fold of the root seed — order-independent, elastic.
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, step, cfg.host_id])
        )
        # Markov-ish stream: mixture of a linear-congruential walk and noise —
        # has learnable structure (tests check loss decreases) yet is cheap.
        b = per_host
        s = cfg.seq_len + 1
        start = rng.integers(0, cfg.vocab_size, size=(b, 1))
        steps = rng.integers(1, 7, size=(b, s - 1))
        walk = (np.cumsum(steps, axis=1) * 31 + start) % cfg.vocab_size
        noise_mask = rng.random((b, s - 1)) < 0.1
        noise = rng.integers(0, cfg.vocab_size, size=(b, s - 1))
        seq = np.concatenate([start, np.where(noise_mask, noise, walk)], axis=1)
        seq = seq.astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._host_batch(self.step)
        self.step += 1
        return batch


def pack_documents(
    docs: List[np.ndarray], seq_len: int, pad_id: int = 0
) -> Dict[str, np.ndarray]:
    """Greedy packing of variable-length docs into (n, seq_len) rows with
    segment ids (for packed-example attention masking)."""
    rows, segs = [], []
    cur, cur_seg, seg_idx = [], [], 1
    for doc in docs:
        doc = doc[: seq_len]  # truncate over-long docs
        if len(cur) + len(doc) > seq_len:
            pad = seq_len - len(cur)
            rows.append(np.concatenate([cur, np.full(pad, pad_id, np.int32)]))
            segs.append(np.concatenate([cur_seg, np.zeros(pad, np.int32)]))
            cur, cur_seg, seg_idx = [], [], 1
        cur = np.concatenate([cur, doc]).astype(np.int32) if len(cur) else doc.astype(np.int32)
        cur_seg = (
            np.concatenate([cur_seg, np.full(len(doc), seg_idx, np.int32)])
            if len(cur_seg)
            else np.full(len(doc), seg_idx, np.int32)
        )
        seg_idx += 1
    if len(cur):
        pad = seq_len - len(cur)
        rows.append(np.concatenate([cur, np.full(pad, pad_id, np.int32)]))
        segs.append(np.concatenate([cur_seg, np.zeros(pad, np.int32)]))
    return {"tokens": np.stack(rows), "segment_ids": np.stack(segs)}
