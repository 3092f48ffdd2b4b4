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

Ranks (`group`, the process group of the ranks training together, or
one group per mesh axis, which together reach every rank of the mesh):
the rank at coordinate 0 of every group alone writes checkpoints and the
others wait at a barrier; every rank restores.  Under a 'model' axis
(`blocks`, the step's `interop.ModelBlocks`) every rank first gathers the
global tree, which the writer saves, and a restore reads the global tree
and keeps this rank's blocks (`restore_state`), so a checkpoint restores
on any mesh, one process included.  The restart decision is the same on every
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
from repro_torch.tree import tree_map

__all__ = ["LoopConfig", "restore_state", "train_loop"]


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


def restore_state(ckpt: CheckpointManager, step: int, state: Dict[str, Any], blocks=None):
    """Checkpoint `step` restored into the structure of `state`; with
    `blocks` (a rank's blocks under a 'model' axis), the global tree read
    on the host and this rank's blocks of it kept, on `state`'s devices."""
    if blocks is None:
        return ckpt.restore(step, state)
    mine = blocks.cut(ckpt.restore(step, blocks.global_like(state)))
    return tree_map(lambda t, like: t.to(like.device), mine, state)


def train_loop(
    train_step: Callable,
    state: Dict[str, Any],
    data_iter,
    cfg: LoopConfig,
    ckpt: Optional[CheckpointManager] = None,
    logger: Optional[MetricsLogger] = None,
    failure_hook: Optional[Callable[[int], None]] = None,
    checkpointer=None,  # optional AsyncCheckpointer wrapping `ckpt`
    group=None,  # the ranks' process group, or one group per mesh axis
    blocks=None,  # the step's interop.ModelBlocks under a 'model' axis
) -> Dict[str, Any]:
    """Runs to cfg.total_steps; returns the final state.

    `data_iter` must expose .state()/.restore(step) (see data/pipeline.py);
    checkpoint metadata records the data position so resume is exact.
    Under `group`, only the writer (coordinate 0 of every group) passes a
    `checkpointer`.
    """
    owns_logger = logger is None
    logger = logger or MetricsLogger()
    step = int(state["step"])
    restarts = 0
    stragglers = 0
    groups = [g for g in (group if isinstance(group, (list, tuple)) else [group])
              if g is not None]
    writes = all(dist.get_rank(g) == 0 for g in groups)

    def barrier() -> None:
        for g in groups:
            dist.barrier(g)

    def save(step_i: int) -> None:
        if ckpt is None:
            return
        meta = {"data_step": data_iter.state()}
        tree = state if blocks is None else blocks.gather(state, device="cpu")
        if checkpointer is not None:
            checkpointer.submit(step_i, tree, meta)
        elif writes:
            ckpt.save(step_i, tree, meta)
        del tree
        barrier()

    while step < cfg.total_steps:
        try:
            failed = None
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = next(data_iter)
            except Exception as e:  # noqa: BLE001 - re-raised on every rank below
                failed = e
            if groups or failed is not None:
                raise_together(failed, groups, state["step"].device)
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
            barrier()  # the writer's checkpoints are on disk
            latest = ckpt.latest_step()
            logger.warn(
                f"step {step} failed ({type(e).__name__}: {e}); "
                f"restoring step {latest} (restart {restarts}/{cfg.max_restarts})"
            )
            if latest is None:
                raise
            state = restore_state(ckpt, latest, state, blocks)
            data_iter.restore(ckpt.meta(latest)["data_step"])
            step = latest
    if checkpointer is not None:
        checkpointer.wait()
    logger.summary({"restarts": restarts, "stragglers": stragglers, "final_step": step})
    if owns_logger:
        logger.close()  # a caller-provided logger stays open for the caller
    return state
