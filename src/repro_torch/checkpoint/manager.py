"""Atomic, versioned, checksummed checkpoints (port of
`repro.checkpoint.manager`, same on-disk layout).

Layout:  <dir>/step_<N>/arrays.npz + meta.json   (tmp-dir + os.replace rename
gives single-writer atomicity; a crashed write can never be mistaken for a
complete checkpoint).  keep_n old steps are garbage-collected after a
successful save.

Leaves are keyed by their dict path ("params/blocks/attn/wq"), and bf16
leaves are stored as their uint16 bits under "<key>::bf16" — the
reference's format, so a checkpoint written by the JAX package restores
into the port and the other way round.  `save` records a sha256 digest of
arrays.npz in meta.json and `restore` verifies it first: a checkpoint whose
bytes rotted is quarantined to `<dir>.corrupt`, recorded in the resilience
ledger and surfaced as `CorruptCheckpointError`, so `all_steps()` never
offers it for resume again.  Pre-digest checkpoints restore unverified.
`checkpoint/async_writer.AsyncCheckpointer` runs `save` on a worker thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.resilience import ledger as _ledger
from repro_torch.tree import tree_map_with_path, tree_paths

__all__ = ["CheckpointManager", "CorruptCheckpointError"]


class CorruptCheckpointError(OSError):
    """arrays.npz bytes do not match the digest recorded at save time."""


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        # npz can't hold bf16 natively: store raw bits + dtype tag.
        if t.dtype == torch.bfloat16:
            flat[key + "::bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat


def _structure(tree: Any) -> str:
    """A readable record of the tree's keys (the reference stores its
    PyTreeDef string; neither side reads it back)."""
    return json.dumps([k for k, _ in tree_paths(tree)])


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_")
        try:
            arrays_path = os.path.join(tmp, "arrays.npz")
            np.savez(arrays_path, **_flatten(tree))
            meta = {
                "step": step,
                "treedef": _structure(tree),
                "digest": _file_digest(arrays_path),
                **(extra_meta or {}),
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):  # overwrite-same-step: replace atomically
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.startswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of `like` (a tree of tensors): each
        leaf comes back with its stored dtype, on the device of the matching
        leaf of `like` (on the host where that leaf is a meta tensor, a
        shape alone: `interop.ModelBlocks.global_like`)."""
        self._verify_digest(step)
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as data:

            def load(key, leaf):
                if key + "::bf16" in data:
                    bits = data[key + "::bf16"].view(np.int16)
                    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
                elif key in data:
                    t = torch.from_numpy(np.array(data[key]))
                else:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {tuple(t.shape)} != model {tuple(leaf.shape)}"
                    )
                return t if str(leaf.device) == "meta" else t.to(leaf.device)

            return tree_map_with_path(load, like)

    def _verify_digest(self, step: int) -> None:
        """Quarantine + raise if arrays.npz fails its recorded checksum.

        `all_steps()` only parses `step_<digits>` names, so the `.corrupt`
        -suffixed quarantine directory drops out of the resume candidates.
        """
        step_dir = os.path.join(self.directory, f"step_{step:08d}")
        recorded = self.meta(step).get("digest")
        if recorded is None:  # pre-digest checkpoint: restore unverified
            return
        actual = _file_digest(os.path.join(step_dir, "arrays.npz"))
        if actual == recorded:
            return
        quarantine = step_dir + ".corrupt"
        shutil.rmtree(quarantine, ignore_errors=True)
        os.replace(step_dir, quarantine)
        _ledger.record(
            "checkpoint.read",
            cause=f"digest mismatch: {actual} != recorded {recorded}",
            fallback="quarantine",
            step=step,
        )
        raise CorruptCheckpointError(
            f"checkpoint step {step} failed its content digest "
            f"({actual} != {recorded}); quarantined to {quarantine}"
        )

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step:08d}", "meta.json")) as f:
            return json.load(f)
