"""The mesh-array scrambling transformation S (Kak 2010).

Port of `repro.core.scramble`: the closed form of sigma_n, the flat
permutation vectors, S^k via cycle decomposition, the order of S, and the
tensor-level scrambling system (`apply_scramble`, `unscramble`,
`apply_scramble_power`, `sigma_traced`).  The mesh kernel's `scramble_out`
mode reads its block table from here.

`apply_scramble_power` takes a runtime key k (an integer tensor, on the
device) without a host sync.  The reference gathers row k % order of an
(order, n^2) table of every power; order(S) is 189 at n = 8 but 4.4e13 at
n = 64 and 6.5e24 at n = 1024, so the port keeps the cycle structure
instead: per element its cycle's start in a concatenation of all cycles,
its position and the cycle's length, O(n^2) for any n.  S^k then sends
element e to cycles[start[e] + (pos[e] + k) % len[e]], which is row
k % order of the reference's table (every cycle length divides the order).

Closed form, for 1-indexed cell (i, j) with d = i + j:

    if d <= n + 1:  m, f, r = d - 1,      d - 1,      i
    else:           m, f, r = 2n + 1 - d, 2n + 2 - d, i - (d - n) + 1
    h = ceil(m / 2)
    v = m - 2(r - 1)                      if r <= h
      = 2(r - h)      (m odd)             otherwise
      = 2(r - h) - 1  (m even)
    sigma(i, j) = (f, v) if d even else (v, f)
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

__all__ = [
    "sigma",
    "sigma_table",
    "scramble_perm",
    "inverse_perm",
    "power_perm",
    "apply_scramble",
    "unscramble",
    "apply_scramble_power",
    "cycle_decomposition",
    "scramble_order",
    "sigma_traced",
    "block_scramble_perm",
    "scrambled_cell_of",
    "format_table",
]


def sigma(n: int, i: int, j: int) -> Tuple[int, int]:
    """sigma_n applied to 1-indexed cell (i, j) -> 1-indexed subscripts (p, q).

    Node (i, j) of the n x n mesh array computes c_{p,q} of C = AB.
    """
    if not (1 <= i <= n and 1 <= j <= n):
        raise ValueError(f"cell ({i},{j}) out of range for n={n}")
    d = i + j
    if d <= n + 1:
        m, f, r = d - 1, d - 1, i
    else:
        m, f, r = 2 * n + 1 - d, 2 * n + 2 - d, i - (d - n) + 1
    h = (m + 1) // 2
    if r <= h:
        v = m - 2 * (r - 1)
    else:
        v = 2 * (r - h) if m % 2 == 1 else 2 * (r - h) - 1
    return (f, v) if d % 2 == 0 else (v, f)


@functools.lru_cache(maxsize=None)
def sigma_table(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The full n x n arrangement table: entry [i-1][j-1] = sigma(n, i, j)."""
    return tuple(
        tuple(sigma(n, i, j) for j in range(1, n + 1)) for i in range(1, n + 1)
    )


@functools.lru_cache(maxsize=None)
def _scramble_perm_np(n: int) -> np.ndarray:
    """Flat permutation vector: scrambled.flat[cell] = standard.flat[perm[cell]].

    cell = (i-1)*n + (j-1) indexes the mesh node; perm[cell] = (p-1)*n + (q-1)
    where sigma(i, j) = (p, q).  Cached: callers must not mutate it.
    """
    perm = np.empty(n * n, dtype=np.int32)
    for i in range(1, n + 1):
        for j in range(1, n + 1):
            p, q = sigma(n, i, j)
            perm[(i - 1) * n + (j - 1)] = (p - 1) * n + (q - 1)
    return perm


def scramble_perm(n: int) -> np.ndarray:
    """Flat gather indices realizing S (copy — safe to mutate)."""
    return _scramble_perm_np(n).copy()


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    """Inverse of a flat permutation vector."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def power_perm(perm: np.ndarray, k: int) -> np.ndarray:
    """perm composed with itself k times (k may be negative), via cycles:
    each element advances k mod (its cycle length) positions, so the cost is
    O(n^2) whatever k is."""
    size = perm.shape[0]
    out = np.empty_like(perm)
    seen = np.zeros(size, dtype=bool)
    for start in range(size):
        if seen[start]:
            continue
        cyc = [start]
        seen[start] = True
        cur = int(perm[start])
        while cur != start:
            seen[cur] = True
            cyc.append(cur)
            cur = int(perm[cur])
        clen = len(cyc)
        shift = k % clen
        for idx, elem in enumerate(cyc):
            out[elem] = cyc[(idx + shift) % clen]
    return out


def cycle_decomposition(n: int) -> List[List[Tuple[int, int]]]:
    """Cycles of S written over 1-indexed subscripts, paper convention (S
    sends standard position (p, q) to the mesh cell that holds c_{p,q})."""
    perm = _scramble_perm_np(n)
    inv = inverse_perm(perm)
    seen = np.zeros(n * n, dtype=bool)
    cycles: List[List[Tuple[int, int]]] = []
    for start in range(n * n):
        if seen[start]:
            continue
        cyc = []
        cur = start
        while not seen[cur]:
            seen[cur] = True
            cyc.append((cur // n + 1, cur % n + 1))
            cur = int(inv[cur])
        cycles.append(cyc)
    return cycles


@functools.lru_cache(maxsize=None)
def scramble_order(n: int) -> int:
    """Order (period) of S: lcm of cycle lengths.  Paper: 7, 7, 20 for n=3,4,5."""
    return math.lcm(*[len(c) for c in cycle_decomposition(n)])


# ---------------------------------------------------------------------------
# Tensor application: the "scrambling system" entry points.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inverse_perm_np(n: int) -> np.ndarray:
    """inverse_perm of sigma_n's flat vector, cached (callers must not mutate)."""
    return inverse_perm(_scramble_perm_np(n))


@functools.lru_cache(maxsize=None)
def _cycle_tables_np(n: int) -> Tuple[np.ndarray, ...]:
    """(cycles, start, pos, length) of sigma_n's flat permutation, each
    (n^2,) int64 (callers must not mutate them).

    `cycles` concatenates every cycle in the order `power_perm` traces them
    (element, perm[element], ...); element e sits at cycles[start[e] +
    pos[e]], and `length[e]` is the length of its cycle.
    """
    perm = _scramble_perm_np(n)
    size = perm.shape[0]
    cycles = np.empty(size, dtype=np.int64)
    start = np.empty(size, dtype=np.int64)
    length = np.empty(size, dtype=np.int64)
    seen = np.zeros(size, dtype=bool)
    at = 0
    for s in range(size):
        if seen[s]:
            continue
        first = at
        cur = s
        while not seen[cur]:
            seen[cur] = True
            cycles[at] = cur
            at += 1
            cur = int(perm[cur])
        members = cycles[first:at]
        start[members] = first
        length[members] = at - first
    pos = np.empty(size, dtype=np.int64)
    pos[cycles] = np.arange(size)
    return cycles, start, pos - start, length


def _power_perm_np(n: int, k: int) -> np.ndarray:
    """power_perm(sigma_n's flat vector, k) from the cycle tables, any k."""
    cycles, start, pos, length = _cycle_tables_np(n)
    return cycles[start + (pos + k) % length]


_DEVICE_TABLES: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}


def _cycle_tables_on(n: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """`_cycle_tables_np(n)` on `device`, uploaded once per (n, device)."""
    key = (n, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = tuple(torch.as_tensor(x, device=device) for x in _cycle_tables_np(n))
        _DEVICE_TABLES[key] = t
    return t


def _gather_flat(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    flat = x.reshape(*x.shape[:-2], n * n)
    return flat.index_select(-1, perm).reshape(x.shape)


def _check_square(x: torch.Tensor, name: str) -> int:
    n = x.shape[-1]
    if x.dim() < 2 or x.shape[-2] != n:
        raise ValueError(f"{name} needs trailing (n, n) dims, got {tuple(x.shape)}")
    return n


def apply_scramble(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Apply S^k to the trailing two (n, n) dims of x: one gather, any k
    (negative k unscrambles)."""
    n = _check_square(x, "apply_scramble")
    perm = torch.as_tensor(_power_perm_np(n, int(k)), device=x.device)
    return _gather_flat(x, perm)


def unscramble(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Inverse of apply_scramble — recover the standard arrangement."""
    return apply_scramble(x, -k)


def apply_scramble_power(
    x: torch.Tensor, k: Union[int, torch.Tensor], n: int
) -> torch.Tensor:
    """S^k with a runtime integer key k (a Python int or an integer tensor),
    trailing dims (n, n); the key space is Z_order(S).

    A tensor key stays on its device: the power's gather indices come from
    the cycle tables (uploaded once per (n, device)) by elementwise integer
    ops, so nothing is read back to the host.
    """
    if x.shape[-2:] != (n, n):
        raise ValueError(f"apply_scramble_power needs trailing ({n}, {n}) dims, got {tuple(x.shape)}")
    if not isinstance(k, torch.Tensor):
        return apply_scramble(x, int(k))
    if k.dtype.is_floating_point or k.dtype == torch.bool or k.numel() != 1:
        raise ValueError(f"k must be one integer, got {k.dtype} of shape {tuple(k.shape)}")
    cycles, start, pos, length = _cycle_tables_on(n, x.device)
    kk = k.to(device=x.device, dtype=torch.int64).reshape(())
    perm = cycles[start + torch.remainder(pos + kk, length)]
    return _gather_flat(x, perm)


def sigma_traced(n: int, i, j):
    """Closed-form sigma_n on 0-indexed block indices (i, j) -> (p, q),
    elementwise on integer tensors (or Python ints); n is a Python int."""
    i = torch.as_tensor(i)
    j = torch.as_tensor(j)
    i1, j1 = i + 1, j + 1
    d = i1 + j1
    low = d <= n + 1
    m = torch.where(low, d - 1, 2 * n + 1 - d)
    f = torch.where(low, d - 1, 2 * n + 2 - d)
    r = torch.where(low, i1, i1 - (d - n) + 1)
    h = torch.div(m + 1, 2, rounding_mode="floor")
    v = torch.where(
        r <= h,
        m - 2 * (r - 1),
        torch.where(m % 2 == 1, 2 * (r - h), 2 * (r - h) - 1),
    )
    even = d % 2 == 0
    p = torch.where(even, f, v)
    q = torch.where(even, v, f)
    return p - 1, q - 1


def block_scramble_perm(n_blocks: int) -> np.ndarray:
    """sigma at block granularity: permutation of an (n_blocks x n_blocks)
    tile grid (the mesh kernel's `scramble_out` placement)."""
    return _scramble_perm_np(n_blocks).copy()


def scrambled_cell_of(n: int, p: int, q: int) -> Tuple[int, int]:
    """Which mesh cell (i, j) holds c_{p,q}?  (All args/results 1-indexed.)"""
    cell = int(_inverse_perm_np(n)[(p - 1) * n + (q - 1)])
    return cell // n + 1, cell % n + 1


def format_table(n: int) -> str:
    """Render the arrangement table in the paper's `pq` notation."""
    rows = []
    for row in sigma_table(n):
        rows.append(" ".join(f"{p}{q}" if n < 10 else f"{p},{q}" for p, q in row))
    return "\n".join(rows)
