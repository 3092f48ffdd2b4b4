"""Numeric guardrail policies and bounded retry/backoff (port of
`repro.resilience.policy`).

Two small primitives the rest of the resilience layer is built from:

  * `nonfinite_count` / `scrub_nonfinite` — the NaN/Inf detection used by
    the `guard_nonfinite` plan option (`kernels/api.plan`), sampling-aware
    so big outputs can be spot-checked instead of fully reduced;
  * `retry_call` — bounded retry with exponential backoff for the I/O edges,
    recording each retry in the resilience ledger.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

import torch

from repro_torch.resilience import ledger

__all__ = [
    "GUARD_POLICIES",
    "NonFiniteError",
    "nonfinite_count",
    "normalize_policy",
    "retry_call",
    "scrub_nonfinite",
]

T = TypeVar("T")

# guard_nonfinite policies (kernels/api.plan):
#   raise            NonFiniteError on any sampled NaN/Inf
#   fallback         re-execute on the next backend in the plan's chain
#   zero_and_record  replace non-finite entries with 0 and record the event
GUARD_POLICIES = ("raise", "fallback", "zero_and_record")


class NonFiniteError(FloatingPointError):
    """A guarded plan produced NaN/Inf under the `raise` policy."""


def normalize_policy(policy: str) -> str:
    """Accept hyphenated spellings ("zero-and-record") for the CLI edge."""
    p = str(policy).replace("-", "_")
    if p not in GUARD_POLICIES:
        raise ValueError(
            f"guard policy must be one of {GUARD_POLICIES}, got {policy!r}"
        )
    return p


def nonfinite_count(x: torch.Tensor, sample: Optional[int] = None) -> int:
    """Number of non-finite entries in `x`; the count is read to the host.

    `sample` checks an evenly strided subset of that many elements instead of
    the full tensor — the guard's cheap spot-check for big outputs.  Sampling
    can miss a poisoned tail; it is a cost/coverage dial, not a proof.
    """
    flat = x.reshape(-1)
    if sample is not None and 0 < sample < flat.shape[0]:
        stride = flat.shape[0] // sample
        flat = flat[:: max(stride, 1)]
    return int((~torch.isfinite(flat)).sum().item())


def scrub_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Replace NaN/Inf with exact zeros (no host sync)."""
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def retry_call(
    fn: Callable[[], T],
    *,
    retries: int = 2,
    base_delay: float = 0.05,
    max_delay: float = 1.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    site: str = "retry",
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run `fn`, retrying up to `retries` times with exponential backoff.

    Each retry records a DegradationEvent (site, cause, "retry#n") so
    transient I/O failures are visible even when they ultimately succeed.
    After the bounded retries are exhausted the LAST error is re-raised —
    surfacing, not swallowing.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise
            ledger.record(
                site,
                cause=f"{type(e).__name__}: {e}",
                fallback=f"retry#{attempt}",
                attempts_left=retries - attempt,
            )
            delay = min(base_delay * (2 ** (attempt - 1)), max_delay)
            if delay > 0:
                sleep(delay)
