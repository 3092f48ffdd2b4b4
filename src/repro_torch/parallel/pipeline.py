"""Pipeline parallelism over a 'stage' mesh axis: schedules and the
forward loop (port of `repro.parallel.pipeline`).

Stages hold disjoint layer ranges (stacked stage-major params, one slice a
rank); microbatches flow through the stage ring.  Two schedules are
modelled:

  gpipe  fill -> steady -> drain over M + S - 1 forward ticks; all M
         microbatches are in flight at the steady peak.
  1f1b   one-forward-one-backward: after the S-1-tick fill each stage
         alternates one forward with one backward tick, so at most
         min(S, M) microbatches are ever in flight.  The bubble fraction
         is the SAME (S-1)/(M+S-1) as GPipe: 1F1B's win is peak
         activation memory, not bubble time (Narayanan et al., PipeDream).

`pipeline_ticks` gives the exact fill/steady/drain tick counts per
schedule; `bubble_fraction` is the headline scalar.

`pipeline_apply` is the executable forward loop (the GPipe tick
structure), SPMD in place of `shard_map`: each process runs its own stage.
Each tick's stage hop (`collectives._Hop`, the reference's `ppermute`) is
posted directly after the stage function, before the drain bookkeeping,
and waited at the end of the tick.  A stage that holds no microbatch at a
tick skips its function and sends zeros (the reference computes and masks
to zeros: the same values).  The last stage's outputs reach every rank by
an all-reduce sum of the zero-filled buffers, the reference's `psum`.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.collectives import _hops, all_reduce, axis_group
from repro_torch.parallel.sharding import mesh_layout
from repro_torch.tree import tree_map

__all__ = ["bubble_fraction", "pipeline_apply", "pipeline_ticks"]


def pipeline_ticks(num_stages: int, num_micro: int, *, schedule: str = "gpipe") -> dict:
    """Exact tick accounting for a pipeline schedule: fill/steady/drain/
    total tick counts, the bubble (idle stage-ticks), the bubble fraction,
    and the peak number of microbatches in flight, the quantity that
    separates 1F1B from GPipe.  `gpipe` counts forward ticks only
    (matching `pipeline_apply`); `1f1b` counts forward+backward ticks."""
    s, m = int(num_stages), int(num_micro)
    if s < 1 or m < 1:
        raise ValueError(f"need num_stages >= 1 and num_micro >= 1, got {s}, {m}")
    fill = s - 1  # ticks before the last stage sees microbatch 0
    drain = s - 1  # ticks after the first stage goes idle
    if schedule == "gpipe":
        total = m + s - 1
        work = m  # forward ticks each stage executes
        peak = m  # all microbatches' activations live through the fill
    elif schedule == "1f1b":
        # After the fill each stage strictly alternates 1 fwd / 1 bwd, so a
        # microbatch's backward frees its activation before fwd s+1 starts.
        total = 2 * (m + s - 1)
        work = 2 * m
        peak = min(s, m)
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    steady = total - fill - drain  # ticks with every stage busy
    bubble = total - work  # idle ticks per stage
    return {
        "schedule": schedule,
        "num_stages": s,
        "num_micro": m,
        "fill": fill,
        "steady": steady,
        "drain": drain,
        "total": total,
        "bubble": bubble,
        "bubble_fraction": (s - 1) / (m + s - 1),
        "peak_in_flight": peak,
    }


def bubble_fraction(num_stages: int, num_micro: int, *, schedule: str = "gpipe") -> float:
    """Idle fraction of the pipeline: (S-1)/(M+S-1) for gpipe AND 1f1b."""
    return pipeline_ticks(num_stages, num_micro, schedule=schedule)["bubble_fraction"]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run x through the stages of `axis`, microbatch-pipelined.

    stage_fn:     (params of one stage, activation (mb, ...)) -> activation
                  of the same shape and dtype
    stage_params: this rank's slice of the stage-stacked tree, leading dim
                  1 on every leaf (what the reference's shard_map body sees;
                  `sharding.shard_of(..., P(axis))` cuts it from the stack)
    x_micro:      (num_micro, mb, ...) microbatched input, the same on
                  every rank
    Returns (num_micro, mb, ...), the last stage's outputs, on every rank.
    """
    num_stages, s, ranks = mesh_layout(mesh).ring(axis)
    num_micro = x_micro.shape[0]
    ticks = num_micro + num_stages - 1
    params_one = tree_map(lambda p: p[0], stage_params)
    zero = torch.zeros_like(x_micro[0])
    carry_in = zero  # the activation stage s-1 produced on the previous tick
    outputs = torch.zeros_like(x_micro)
    perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    with _hops(ranks, s) as hop:
        for t in range(ticks):
            active = 0 <= t - s < num_micro
            y = zero
            if active:
                # Stage 0 ingests microbatch t; the others take the hop.
                y = stage_fn(params_one, x_micro[t] if s == 0 else carry_in)
            h = hop(y, perm) if t < ticks - 1 else None  # in flight meanwhile
            # Drain: the last stage owns microbatch t-(S-1) at tick t.
            m_out = t - (num_stages - 1)
            if active and s == num_stages - 1 and 0 <= m_out < num_micro:
                outputs[m_out] = y
            if h is not None:
                carry_in = h.wait()
    group, _, _ = axis_group(mesh, axis)
    return outputs if group is None else all_reduce(outputs, group=group)
