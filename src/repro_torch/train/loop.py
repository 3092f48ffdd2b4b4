"""Fault-tolerant training loop (port of `repro.train.loop`).

Mechanics:
  * periodic checkpoints (sync, or async through `checkpointer`) +
    auto-resume from latest,
  * crash recovery: a step that raises is retried from the last checkpoint
    (up to max_restarts); the deterministic step-indexed data pipeline makes
    recovery bit-exact,
  * straggler mitigation: per-step wall-clock deadline; slow steps are logged
    and counted,
  * failure injection hook for tests (`failure_hook(step) -> None|raise`).

A step's time is taken after `torch.cuda.synchronize()` on the card (the
reference's `block_until_ready`), so it is the device's time, not the
enqueue.

Data-parallel ranks (`group`, the process group of the ranks training
together): rank 0 alone writes checkpoints and the others wait at a
barrier; every rank restores.  The restart decision is the same on every
rank: a failure before the step (the hook, the data) is agreed by one
all-reduce of a flag, and the data-parallel step agrees on failures of its
local computation itself (`train_step.make_train_step` with a mesh), so no rank
restarts alone while the others wait in a collective.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.parallel.collectives import raise_together
from repro_torch.train.metrics import MetricsLogger

__all__ = ["LoopConfig", "train_loop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    max_restarts: int = 3
    step_deadline_s: Optional[float] = None  # straggler threshold
    log_every: int = 10


def _sync(state: Dict[str, Any]) -> None:
    if state["step"].device.type == "cuda":
        torch.cuda.synchronize(state["step"].device)


def train_loop(
    train_step: Callable,
    state: Dict[str, Any],
    data_iter,
    cfg: LoopConfig,
    ckpt: Optional[CheckpointManager] = None,
    logger: Optional[MetricsLogger] = None,
    failure_hook: Optional[Callable[[int], None]] = None,
    checkpointer=None,  # optional AsyncCheckpointer wrapping `ckpt`
    group=None,  # the data-parallel ranks' process group, if any
) -> Dict[str, Any]:
    """Runs to cfg.total_steps; returns the final state.

    `data_iter` must expose .state()/.restore(step) (see data/pipeline.py);
    checkpoint metadata records the data position so resume is exact.
    Under `group`, only rank 0 passes a `checkpointer`.
    """
    owns_logger = logger is None
    logger = logger or MetricsLogger()
    step = int(state["step"])
    restarts = 0
    stragglers = 0
    writes = group is None or dist.get_rank(group) == 0

    def save(step_i: int) -> None:
        if ckpt is None:
            return
        meta = {"data_step": data_iter.state()}
        if checkpointer is not None:
            checkpointer.submit(step_i, state, meta)
        elif writes:
            ckpt.save(step_i, state, meta)
        if group is not None:
            dist.barrier(group)

    while step < cfg.total_steps:
        try:
            failed = None
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = next(data_iter)
            except Exception as e:  # noqa: BLE001 - re-raised on every rank below
                failed = e
            if group is not None or failed is not None:
                raise_together(failed, group, state["step"].device)
            t0 = time.monotonic()
            state, metrics = train_step(state, batch)
            _sync(state)
            dt = time.monotonic() - t0
            if cfg.step_deadline_s is not None and dt > cfg.step_deadline_s:
                stragglers += 1
                logger.warn(
                    f"straggler: step {step} took {dt:.3f}s "
                    f"(deadline {cfg.step_deadline_s}s) — count={stragglers}"
                )
            step += 1
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                save(step)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # crash recovery path
            restarts += 1
            if ckpt is None or restarts > cfg.max_restarts:
                raise
            if checkpointer is not None:
                checkpointer.wait()
            if group is not None:
                dist.barrier(group)  # rank 0's writes are on disk
            latest = ckpt.latest_step()
            logger.warn(
                f"step {step} failed ({type(e).__name__}: {e}); "
                f"restoring step {latest} (restart {restarts}/{cfg.max_restarts})"
            )
            if latest is None:
                raise
            state = ckpt.restore(latest, state)
            data_iter.restore(ckpt.meta(latest)["data_step"])
            step = latest
    if checkpointer is not None:
        checkpointer.wait()
    logger.summary({"restarts": restarts, "stragglers": stragglers, "final_step": step})
    if owns_logger:
        logger.close()  # a caller-provided logger stays open for the caller
    return state
