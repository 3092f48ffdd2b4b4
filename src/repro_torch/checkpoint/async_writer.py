"""Async checkpointing: snapshot on the calling thread, serialize on a worker
(port of `repro.checkpoint.async_writer`).

The train loop calls `submit(step, tree)`.  The snapshot is taken at once,
so a caller who mutates the tree after `submit` (the port's AdamW updates
in place) does not change the checkpoint.  It goes into one set of host
buffers, allocated on the first `submit` (again only if the leaves' shapes
or dtypes change) and reused: pinned for CUDA leaves, plain for CPU ones.
So the writer holds at most one host copy of the tree, and `submit` first
waits for the previous write, which still reads those buffers:

  * a CUDA leaf is copied with a `non_blocking` copy on the current stream,
    and one CUDA event is recorded after the last copy.  `submit` never
    waits for the device; the next step's in-place update is queued on the
    same stream, behind the copies.  The worker waits on the event (polling
    it, so it never blocks the device or trips CUDA's sync debug mode),
    then serializes;
  * a CPU tensor is copied into its buffer and a numpy array copied.

Under a 'model' axis the train loop submits the global tree, gathered by
every rank onto the host (`train_loop(blocks=)`), from the writer rank.
The npz write + rename happens on the worker thread.  Errors surface on the
next submit/wait and again in `close()`/`__exit__`: a failed write never
silently drops a checkpoint.  Transient write failures are absorbed by
bounded retry with exponential backoff (`resilience.policy.retry_call`,
site "checkpoint.write"), each retry recorded in the resilience ledger.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.policy import retry_call as _retry_call
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["AsyncCheckpointer"]


class AsyncCheckpointer:
    """Background checkpoint writer; usable as a context manager.

    `retries`/`backoff` bound the per-checkpoint write retries (exponential
    backoff, capped at `max_backoff` seconds).  `retries=0` disables retry.
    `waited_s` is how long the last `submit` waited for the previous write.
    """

    def __init__(
        self,
        manager: CheckpointManager,
        *,
        retries: int = 2,
        backoff: float = 0.05,
        max_backoff: float = 1.0,
    ):
        self.manager = manager
        self.retries = retries
        self.backoff = backoff
        self.max_backoff = max_backoff
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._host: Optional[List[Optional[torch.Tensor]]] = None  # one buffer per leaf
        self._host_key: Optional[list] = None
        self.waited_s = 0.0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _save_with_retry(self, step: int, host_tree: Any, meta) -> None:
        def _save_once() -> None:
            _faults.check("checkpoint.write", step=step)
            self.manager.save(step, host_tree, meta)

        _retry_call(
            _save_once,
            retries=self.retries,
            base_delay=self.backoff,
            max_delay=self.max_backoff,
            retry_on=(OSError, _faults.FaultError),
            site="checkpoint.write",
        )

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, meta, copied = item
            try:
                if copied is not None:
                    while not copied.query():  # the device-to-host copies
                        time.sleep(0.001)
                self._save_with_retry(step, host_tree, meta)
            except BaseException as e:  # surfaced on next submit/wait/close
                self._err = e
            finally:
                item = host_tree = None
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def _snapshot(self, tree: Any) -> Any:
        """`tree` with its tensors copied into the host buffers (numpy
        leaves copied)."""
        leaves = tree_leaves(tree)
        key = [(tuple(t.shape), t.dtype, t.is_cuda) if isinstance(t, torch.Tensor) else None
               for t in leaves]
        if key != self._host_key:
            self._host = None  # the old buffers go back before the new ones
            self._host = [None if k is None else torch.empty(k[0], dtype=k[1], pin_memory=k[2])
                          for k in key]
            self._host_key = key
        copies = [np.array(leaf, copy=True) if buf is None
                  else buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                  for leaf, buf in zip(leaves, self._host)]
        return tree_unflatten(tree, copies)

    def submit(self, step: int, tree: Any, meta: Optional[dict] = None) -> None:
        if self._closed:
            raise RuntimeError("submit() on a closed AsyncCheckpointer")
        self._raise_pending()
        t0 = time.monotonic()
        self._q.join()  # the previous write still reads the host buffers
        self.waited_s = time.monotonic() - t0
        self._raise_pending()
        host_tree = self._snapshot(tree)
        copied = None
        if any(k is not None and k[2] for k in self._host_key):
            copied = torch.cuda.Event()
            copied.record()
        self._q.put((step, host_tree, meta, copied))

    def wait(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain the queue, stop the worker, then surface any pending error.

        The thread is always stopped, even when the last write failed — the
        error raises AFTER shutdown so callers are never left with a live
        worker they cannot rejoin.
        """
        if self._closed:
            self._raise_pending()
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._host = self._host_key = None
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
            return
        # An exception is already propagating: still shut down cleanly, but
        # don't let a pending-write error mask the original exception.
        try:
            self.close()
        except RuntimeError:
            pass

