"""The training driver: the port's `make_train_step` in a closed loop of
steps, on the card.

Set-up makes the weights from the seed and the step with its AdamW state
once, and drives that same object through its first three steps on the
stream's first three batches (every row differs): those steps build the
kernels and tune the plans, and give the readings the check compares
(each step's loss, the first gradient's norms from the first moment after
step 1, the change of each leaf over the three steps, read before step 4
overwrites it).  The window then dispatches steps back to back with no
host synchronisation, and one synchronisation at its end: the rate is
every step's tokens over the window's whole time.  The traced run then
profiles whole steps of the same loop just after the window, between two
synchronisations.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from portbench.harness import check, traffic
from portbench.harness.record import RunRecord
from portbench.harness.trace import Profiler, SpanLog
from portbench.harness.weights import make_params

CHECKED_STEPS = 3
PROFILE_S = 2.0  # the traced run profiles whole steps until this much has passed


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def hyper(cell) -> Dict[str, float]:
    t = cell.config["train"]
    return {"lr": t["lr"], "b1": t["b1"], "b2": t["b2"], "eps": t["eps"],
            "weight_decay": t["weight_decay"], "clip_norm": t["clip_norm"]}


def run(cell, cfg, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None) -> Dict[str, object]:
    """One run of a training cell; the result's fields but `device`.
    `fault(step_fn)` (tests only) may wrap the program's step, as a faulty
    program would be."""
    from repro_torch.models import get_model
    from repro_torch.obs import trace as obs
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.train.train_step import make_train_step

    seeds = traffic.Seeds.of(seed)
    hp = hyper(cell)
    rows, seq = cell.config["train"]["rows"], cell.mix["seq_len"]
    model = get_model(cfg)
    params = make_params(model.specs(), cfg, seeds.weights, device)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = make_train_step(model, constant(hp["lr"]),
                              AdamWConfig(b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                                          weight_decay=hp["weight_decay"],
                                          clip_norm=hp["clip_norm"]))
    if fault is not None:
        step_fn = fault(step_fn)
    stream = traffic.BatchStream(seeds.data, rows, seq, cfg.vocab_size, device)

    losses, grad_norms = [], {}
    for k in range(CHECKED_STEPS):
        state, m = step_fn(state, stream.next())
        losses.append(float(m["loss"]))
        if k == 0:
            grad_norms = check.leaf_norms(state["opt"]["m"])
            grad_norms = {p: g / (1 - hp["b1"]) for p, g in grad_norms.items()}
    flat0 = check.flat(make_params(model.specs(), cfg, seeds.weights, device))
    change = check.leaf_norms(state["params"], lambda p, x: x.float() - flat0[p].float())
    del flat0
    log = SpanLog(("portbench.",))
    if trace:
        obs.enable()
        obs.on_span_end(log)
    _sync(device)
    setup_s = time.monotonic() - t_start

    t0 = time.monotonic()
    steps = 0
    while time.monotonic() - t0 < seconds:
        with obs.span("portbench.train_step"):
            state, _ = step_fn(state, stream.next())
        steps += 1
    _sync(device)
    window_s = time.monotonic() - t0
    profile, profiled = None, 0
    if trace:
        # Whole steps just after the window, in the same steady loop, so the
        # profiler's cost falls outside the window's rate.
        prof = Profiler()
        prof.start()
        p0 = time.monotonic()
        while profiled < 1 or time.monotonic() - p0 < PROFILE_S:
            with obs.span("portbench.train_step"):
                state, _ = step_fn(state, stream.next())
            profiled += 1
        profile = prof.stop()
        obs.disable()
        obs.remove_span_end(log)
    tokens_per_s = steps * rows * seq / window_s
    print(f"[train] {steps} steps of {rows} x {seq} tokens in {window_s:.3f} s; set-up losses"
          f" {losses}", file=sys.stderr, flush=True)
    metrics = {"train_tokens_per_s": tokens_per_s, "setup_s": setup_s}
    record = RunRecord(cfg=cfg, cell=cell, peaks=None, profile=profile, spans=log.spans,
                       window=(t0, t0 + window_s), rows=rows, seq_len=seq, steps=steps,
                       window_s=window_s, profiled_steps=profiled)
    peak_bytes = (int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda"
                  else 0)
    prog = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    # The check: the program's state freed, the reference from the seed.
    del state, step_fn, params, stream
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, refr = reference_numbers(cell, cfg, seeds, device, prog)
    gaps = check.leaf_gaps(prog["change_norms"], refr["change_norms"],
                           check.kept_leaves(refr["grad_norms"]))
    for p, ours, theirs, gap in gaps[:4] + [g for g in gaps[4:] if g[1] == 0 < g[2]]:
        print(f"[train] leaf {p}: change norm program {ours:.6g}, reference {theirs:.6g},"
              f" gap {gap:.6g}", file=sys.stderr, flush=True)
    limits = cell.config["correct"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    finite = all(v == v for v in numbers.values())
    correct = bool(finite and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
            "record": record, "checks": checks, "peak_bytes": peak_bytes}


def reference_readings(cell, cfg, seeds, device, *, fp8: bool = False, rows=None):
    """The reference's readings of its three steps from the seed's weights
    on the stream's first batches: losses, first clipped gradient norms
    and change norms.  With `fp8`, or `rows` (the first rows of each batch
    only), the reference run that way, standing in the program's place:
    the control and the half-batch fault."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    nrows, seq = cell.config["train"]["rows"], cell.mix["seq_len"]
    batches = traffic.first_batches(seeds.data, nrows, seq, cfg.vocab_size, device,
                                    CHECKED_STEPS)
    params = {p: x.float() for p, x in
              check.flat(make_params(model.specs(), cfg, seeds.weights, device)).items()}
    tree = check.unflat(params)
    got = check.reference_steps(tree, batches, cfg, hyper(cell), fp8=fp8, rows=rows)
    start = check.flat(make_params(model.specs(), cfg, seeds.weights, device))
    got["change_norms"] = check.leaf_norms(tree, lambda p, x: x - start[p].float())
    return got


def reference_numbers(cell, cfg, seeds, device, prog):
    """The compared numbers of the program's readings `prog` against the
    float32 reference's."""
    refr = reference_readings(cell, cfg, seeds, device)
    return check.train_numbers(prog, refr), refr
