"""The mesh-array scrambling transformation S (Kak 2010) — numpy tables.

Port of the numpy and pure-Python half of `repro.core.scramble`: the closed
form of sigma_n, the flat permutation vectors, S^k via cycle decomposition,
and the order of S.  The mesh kernel's `scramble_out` mode reads its block
table from here.  The tensor-level application (`apply_scramble`) arrives
with the training slice.

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
from typing import List, Tuple

import numpy as np

__all__ = [
    "sigma",
    "sigma_table",
    "scramble_perm",
    "inverse_perm",
    "power_perm",
    "cycle_decomposition",
    "scramble_order",
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
