"""Deterministic fault-injection harness (port of `repro.resilience.faults`).

A degradation path that has never fired is a degradation path that does not
work.  This module lets tests arm failures at named sites without
monkeypatching internals: production code calls `check(site)` at raising
sites and `poison(site, x)` at value sites, and both are near-free when no
plan is armed (one truthiness test on an empty list).

    from repro_torch.resilience import faults

    with faults.inject({"serve.step": faults.FaultSpec(times=1)}):
        server.run(requests)   # one tick is skipped, the server survives

Triggers are deterministic, not probabilistic: a `FaultSpec` fires for
`times` matching calls after skipping the first `after`, then stays dormant.
When several plans are armed (nested `inject`, or the ambient env plan under
a test-local one), the INNERMOST plan that names the site decides — it fires
or passes, and outer plans are not consulted for that call.

Sites instrumented in the port:

  plan.build          `kernels/api.plan` — backend plan construction
                      (ctx: backend)
  plan.execute        Plan.__call__ / dispatch — any execution of a built
                      plan (ctx: backend)
  kernel.output       Plan.__call__ / dispatch — VALUE site: poisons the
                      kernel output with NaN/Inf instead of raising
                      (ctx: backend)
  serve.request       `launch/serve.serve_requests` per-request boundary
                      (ctx: request)
  serve.admit         `launch/scheduler` admission — a fired fault sheds
                      that one request (ctx: rid)
  serve.step          `launch/scheduler` tick boundary — a fired fault
                      skips the tick, never the server (ctx: tick)
  kv.page_alloc       `launch/scheduler.PageAllocator.alloc` — a fired
                      fault defers/stalls the allocation one tick
                      (ctx: reason, rid)

A planner fault degrades a plan down its backend chain only when the plan
was built with `fallback=True`; the port's default (`fallback=False`)
raises it.  The canned plan registry backs `REPRO_FAULT_PLAN`;
`install_env_plan()` arms it for the process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Union

__all__ = [
    "CANNED_PLANS",
    "ENV_PLAN",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "active_plans",
    "check",
    "fire_counts",
    "inject",
    "install_env_plan",
    "poison",
    "uninstall_env_plan",
]

ENV_PLAN = "REPRO_FAULT_PLAN"


class FaultError(RuntimeError):
    """The default injected failure (sites raise it unless the FaultSpec
    pins another exception type)."""


@dataclasses.dataclass
class FaultSpec:
    """One armed failure at one site.

    times   how many matching calls fire before the spec goes dormant
    after   matching calls to skip first (0 = fire from the first call)
    error   exception *class* raised at `check` sites (ignored by `poison`)
    poison  "nan" | "inf": value sites corrupt the array instead of raising
    match   optional {ctx_key: value} filter — the spec only counts calls
            whose keyword context carries every matching item
    """

    times: int = 1
    after: int = 0
    error: type = FaultError
    poison: Optional[str] = None
    match: Optional[Mapping[str, Any]] = None

    def __post_init__(self):
        if self.times < 0 or self.after < 0:
            raise ValueError(f"times/after must be >= 0, got {self}")
        if self.poison not in (None, "nan", "inf"):
            raise ValueError(f"poison must be None|'nan'|'inf', got {self.poison!r}")

    def matches(self, ctx: Mapping[str, Any]) -> bool:
        return all(ctx.get(k) == v for k, v in (self.match or {}).items())


class FaultPlan:
    """A site -> FaultSpec table with per-site trigger accounting."""

    def __init__(
        self, specs: Mapping[str, Union[FaultSpec, Mapping[str, Any]]], *, name: str = ""
    ):
        self.name = name
        self.specs: Dict[str, FaultSpec] = {}
        for site, spec in specs.items():
            if not isinstance(spec, FaultSpec):
                spec = FaultSpec(**dict(spec))
            self.specs[str(site)] = spec
        self._seen: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def sites(self) -> List[str]:
        return list(self.specs)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def _consume(self, site: str, ctx: Mapping[str, Any]) -> Optional[FaultSpec]:
        """Count one matching call; return the spec iff it fires this call."""
        spec = self.specs.get(site)
        if spec is None or not spec.matches(ctx):
            return None
        with self._lock:
            seen = self._seen.get(site, 0)
            self._seen[site] = seen + 1
            if spec.after <= seen < spec.after + spec.times:
                self._fired[site] = self._fired.get(site, 0) + 1
                return spec
        return None


# The armed-plan stack.  A plain list mutated under a lock: fault plans are a
# test/chaos construct, and the instrumented sites only pay a truthiness test
# on it in production (empty list -> immediate return).
_STACK: List[FaultPlan] = []
_STACK_LOCK = threading.Lock()
_ENV_INSTALLED: List[FaultPlan] = []


def active_plans() -> List[FaultPlan]:
    return list(_STACK)


@contextlib.contextmanager
def inject(
    plan: Union[FaultPlan, Mapping[str, Union[FaultSpec, Mapping[str, Any]]]],
) -> Iterator[FaultPlan]:
    """Arm a fault plan for the dynamic extent of the with-block."""
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan)
    with _STACK_LOCK:
        _STACK.append(plan)
    try:
        yield plan
    finally:
        with _STACK_LOCK:
            _STACK.remove(plan)


def _find(site: str, ctx: Mapping[str, Any]) -> Optional[FaultSpec]:
    # Innermost plan naming the site decides; outer plans keep their triggers.
    for plan in reversed(_STACK):
        if site in plan.specs:
            return plan._consume(site, ctx)
    return None


def check(site: str, **ctx: Any) -> None:
    """Raising site: raises the armed error if a matching spec fires."""
    if not _STACK:
        return
    spec = _find(site, ctx)
    if spec is not None and spec.poison is None:
        raise spec.error(f"injected fault at {site!r} (ctx={ctx})")


def poison(site: str, x, **ctx: Any):
    """Value site: returns `x` with one element poisoned if a spec fires.

    Returns a poisoned copy (element 0 set to NaN/Inf); `x` is untouched.
    Specs without a `poison` kind raise, exactly like `check` — a plan may
    choose either behavior for the site.
    """
    if not _STACK:
        return x
    spec = _find(site, ctx)
    if spec is None:
        return x
    if spec.poison is None:
        raise spec.error(f"injected fault at {site!r} (ctx={ctx})")
    bad = float("nan") if spec.poison == "nan" else float("inf")
    out = x.clone()
    out.view(-1)[0] = bad
    return out


def fire_counts() -> Dict[str, int]:
    """Total fires per site across every armed plan (diagnostics)."""
    out: Dict[str, int] = {}
    for plan in _STACK:
        for site in plan.specs:
            out[site] = out.get(site, 0) + plan.fired(site)
    return out


# ---------------------------------------------------------------------------
# Canned plans (REPRO_FAULT_PLAN)
# ---------------------------------------------------------------------------

# One fault per site, once each: the chaos CI job arms this for the whole
# test session and the conftest warmup drives every degradation path through
# it before the ordinary suite runs fault-free.
CANNED_PLANS: Dict[str, Dict[str, FaultSpec]] = {
    "ci-default": {
        "plan.build": FaultSpec(times=1),
        "plan.execute": FaultSpec(times=1),
        "autotune.cache_load": FaultSpec(times=1, error=OSError),
        "collective.step": FaultSpec(times=1),
        "kernel.output": FaultSpec(times=1, poison="nan"),
        "checkpoint.write": FaultSpec(times=1, error=OSError),
        "serve.request": FaultSpec(times=1),
        "serve.admit": FaultSpec(times=1),
        "serve.step": FaultSpec(times=1),
        "kv.page_alloc": FaultSpec(times=1),
    },
}


def install_env_plan() -> Optional[FaultPlan]:
    """Arm the canned plan named by $REPRO_FAULT_PLAN (idempotent).

    Returns the installed plan, or None when the env var is unset.  The plan
    sits at the BOTTOM of the stack, so test-local `inject` blocks shadow it
    site by site.
    """
    name = os.environ.get(ENV_PLAN)
    if not name:
        return None
    if _ENV_INSTALLED:
        return _ENV_INSTALLED[0]
    if name not in CANNED_PLANS:
        raise ValueError(
            f"${ENV_PLAN}={name!r} names no canned fault plan;"
            f" known: {sorted(CANNED_PLANS)}"
        )
    plan = FaultPlan(CANNED_PLANS[name], name=name)
    with _STACK_LOCK:
        _STACK.insert(0, plan)
    _ENV_INSTALLED.append(plan)
    return plan


def uninstall_env_plan() -> None:
    """Disarm the env-installed plan (test teardown)."""
    if _ENV_INSTALLED:
        plan = _ENV_INSTALLED.pop()
        with _STACK_LOCK:
            if plan in _STACK:
                _STACK.remove(plan)
