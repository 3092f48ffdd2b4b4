"""The run's last line, the numbers compared beside their limits, and the
guard that no JAX and no part of the JAX package was loaded."""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List

# Top-level module names a run may not hold once its window has closed,
# compared whole: `repro` is the JAX package; `repro_torch` is the port.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def checks_text(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]


def emit(result: Dict[str, object], modules: Iterable[str] = None) -> int:
    """Print the numbers compared on standard error, then the result line on
    standard output, unless the guard finds a forbidden module among
    `modules` (by default this process's `sys.modules`): then name it on
    standard error, print no result and return 1."""
    bad = forbidden_modules(modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 1
    for line in checks_text(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    ordered = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    ordered["checks"] = result["checks"]  # last, as the contract asks
    print(json.dumps(ordered), flush=True)
    return 0
