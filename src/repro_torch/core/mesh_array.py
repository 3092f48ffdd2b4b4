"""Cycle-accurate simulators for the Kak mesh array and the standard systolic array.

Port of `repro.core.mesh_array`, the reference semantics of the paper: every
node is a MAC cell (paper Fig. 3), and the simulators advance global clock
steps, one loop iteration per array clock step, on the device of their
inputs.  They reproduce, cycle by cycle:

  * mesh array:     2n-1 steps, output in the scrambled arrangement sigma_n,
  * standard array: 3n-2 steps, output in the standard arrangement,
  * symmetric-product early readout by ~ floor(3n/2) steps (paper: <= n+1+n/2).

Node (i, j) of the mesh array performs its k-th MAC (k = 1..n) at step
``start(i, j) + k - 1`` and computes c_{sigma(i,j)}.  Two start models:

  * ``antidiagonal`` (default): start = ceil((i+j)/2), the timing of the
    two-layered construction and the only one consistent with the paper's
    symmetric-matrix claim of ~3n/2+1 steps (`core/symmetries.py`);
  * ``corner``: start = max(i, j) (single-corner feeding, no wraparound).
    Same 2n-1 total; no symmetric early-readout gain.

The standard array uses start = i + j - 1 (the zero-padding skew), total 3n-2.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scramble import _scramble_perm_np

__all__ = [
    "SimResult",
    "mesh_start_times",
    "standard_start_times",
    "mesh_completion_times",
    "standard_completion_times",
    "simulate_mesh",
    "simulate_standard",
    "mesh_matmul_reference",
]

StartModel = Literal["antidiagonal", "corner"]


@dataclasses.dataclass
class SimResult:
    """Output of a cycle-accurate run.

    output:           (n, n) accumulator state after the final step.  For the
                      mesh array this is C in the *scrambled* arrangement;
                      for the standard array it is C itself.
    steps:            number of clock steps executed (2n-1 mesh, 3n-2 standard).
    completion_times: (n, n) int — the step at which each node performed its
                      final MAC.
    history:          (steps, n, n) accumulator after every step (only if
                      ``record_history=True``), used by the early-readout
                      analysis in `core/symmetries.py`.
    """

    output: torch.Tensor
    steps: int
    completion_times: np.ndarray
    history: Optional[torch.Tensor] = None


def mesh_start_times(n: int, model: StartModel = "antidiagonal") -> np.ndarray:
    """(n, n) start step (1-indexed) of each mesh node."""
    i = np.arange(1, n + 1)[:, None]
    j = np.arange(1, n + 1)[None, :]
    if model == "antidiagonal":
        return (i + j + 1) // 2
    if model == "corner":
        return np.maximum(i, j)
    raise ValueError(f"unknown start model {model!r}")


def standard_start_times(n: int) -> np.ndarray:
    """(n, n) start step of each standard-array node (zero-padding skew)."""
    i = np.arange(1, n + 1)[:, None]
    j = np.arange(1, n + 1)[None, :]
    return i + j - 1


def mesh_completion_times(n: int, model: StartModel = "antidiagonal") -> np.ndarray:
    return mesh_start_times(n, model) + n - 1


def standard_completion_times(n: int) -> np.ndarray:
    return standard_start_times(n) + n - 1


def _simulate(
    a: torch.Tensor,
    b: torch.Tensor,
    start: np.ndarray,
    p_idx: np.ndarray,
    q_idx: np.ndarray,
    total_steps: int,
    record_history: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared clock loop, one iteration per clock step.

    Node (i, j) accumulates a[p_idx[i,j], k] * b[k, q_idx[i,j]] where
    k = t - start[i,j] (0-indexed MAC counter) whenever 0 <= k < n: the
    paper's Fig. 3 node semantics (multiply the incoming pair, add to the
    accumulator).  The tables go to the inputs' device once.
    """
    n = a.shape[0]
    dev = a.device
    start_t, p_t, q_t = (
        torch.as_tensor(np.array(x, dtype=np.int64), device=dev) for x in (start, p_idx, q_idx)
    )
    acc_dtype = torch.result_type(a, b)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    acc = torch.zeros((n, n), dtype=acc_dtype, device=dev)
    hist = (
        torch.empty((total_steps, n, n), dtype=acc_dtype, device=dev)
        if record_history
        else None
    )
    for t in range(1, total_steps + 1):
        k = t - start_t  # 0-indexed MAC counter at this node, this step
        active = (k >= 0) & (k < n)
        k_safe = k.clamp(0, n - 1)
        # Incoming operand pair at each node for this clock tick.
        a_val = a[p_t, k_safe]
        b_val = b[k_safe, q_t]
        acc = acc + torch.where(active, a_val * b_val, zero)
        if hist is not None:
            hist[t - 1] = acc
    return acc, hist


def _check_square(a: torch.Tensor, b: torch.Tensor) -> int:
    n = a.shape[0]
    if tuple(a.shape) != (n, n) or tuple(b.shape) != (n, n):
        raise ValueError(
            f"square n x n inputs required, got {tuple(a.shape)} x {tuple(b.shape)}"
        )
    return n


def simulate_mesh(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    model: StartModel = "antidiagonal",
    record_history: bool = False,
) -> SimResult:
    """Run the mesh array on n x n inputs; returns C in scrambled arrangement
    (`unscramble(output) == a @ b`) after exactly 2n-1 steps."""
    n = _check_square(a, b)
    perm = _scramble_perm_np(n)  # flat: cell -> (p*n+q)
    p_idx = (perm // n).reshape(n, n)
    q_idx = (perm % n).reshape(n, n)
    total = 2 * n - 1
    out, hist = _simulate(a, b, mesh_start_times(n, model), p_idx, q_idx, total, record_history)
    return SimResult(
        output=out,
        steps=total,
        completion_times=mesh_completion_times(n, model),
        history=hist,
    )


def simulate_standard(
    a: torch.Tensor, b: torch.Tensor, *, record_history: bool = False
) -> SimResult:
    """Run the standard (Mead–Conway/Kung) array; output in standard arrangement."""
    n = _check_square(a, b)
    idx = np.arange(n)
    p_idx = np.broadcast_to(idx[:, None], (n, n))  # node (i,j) computes c_ij
    q_idx = np.broadcast_to(idx[None, :], (n, n))
    total = 3 * n - 2
    out, hist = _simulate(a, b, standard_start_times(n), p_idx, q_idx, total, record_history)
    return SimResult(
        output=out,
        steps=total,
        completion_times=standard_completion_times(n),
        history=hist,
    )


def mesh_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-shot functional semantics of the mesh array: scrambled(a @ b),
    one gather over the plain matmul (batched over leading dims too)."""
    n = a.shape[-1]
    c = a @ b
    perm = torch.as_tensor(_scramble_perm_np(n), dtype=torch.int64, device=c.device)
    flat = c.reshape(*c.shape[:-2], n * n)
    return flat.index_select(-1, perm).reshape(c.shape)
