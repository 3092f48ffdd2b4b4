"""Symmetry properties of the mesh-array arrangement (Kak 2010).

Port of `repro.core.symmetries` (pure Python over the sigma tables).
Implements and validates the paper's three symmetry claims, and the
symmetric-product early-readout schedule:

  1. Row 1 of the arrangement carries the diagonal c_11, c_22, ..., c_nn.
  2. Mirror rows: for r in 2..n, rows r and n+2-r are reverse-and-transpose
     images of each other (paper states this as "mirror reversed image" with
     subscripts swapped); for even n the middle row n/2+1 is self-symmetric.
  3. Anti-diagonal structure: along anti-diagonal d = i+j, one subscript is
     fixed (first subscript for even d, second for odd d), and the other
     follows the zig-zag (m, m-2, ..., 1|2, ..., m-1).

  4. Early readout: when the product C is symmetric (e.g. Gram products A·Aᵀ,
     or commuting symmetric pairs), each off-row-1 value may be read from
     whichever of the two mirror cells completes first; all values are then
     available by floor(3n/2) steps (paper bound: <= n+1+n/2), versus 2n-1
     for a general product and 3n-2 for the standard array.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.mesh_array import mesh_completion_times
from repro_torch.core.scramble import scrambled_cell_of, sigma, sigma_table

__all__ = [
    "check_row1_diagonal",
    "check_mirror_rows",
    "check_antidiagonal_structure",
    "general_readout_steps",
    "mirror_cell",
    "symmetric_readout_schedule",
    "symmetric_readout_steps",
    "paper_symmetric_bound",
]


def check_row1_diagonal(n: int) -> bool:
    """Claim 1: sigma(1, j) == (j, j) for all j."""
    return all(sigma(n, 1, j) == (j, j) for j in range(1, n + 1))


def mirror_cell(n: int, i: int, j: int) -> Tuple[int, int]:
    """The reverse-and-transpose mirror partner of cell (i, j), rows 2..n.

    Row r column k  <->  row n+2-r column n+1-k.  Row 1 has no partner (it
    carries the diagonal, whose transposes are themselves).
    """
    if i == 1:
        raise ValueError("row 1 has no mirror partner")
    return n + 2 - i, n + 1 - j


def check_mirror_rows(n: int) -> bool:
    """Claim 2: entry at (i, j) is the transpose of the entry at mirror(i, j).

    Covers both the paired rows (2..n/2 vs n/2+2..n et al.) and the middle-row
    self-symmetry for even n (where mirror maps the row onto itself).
    """
    tab = sigma_table(n)
    for i in range(2, n + 1):
        for j in range(1, n + 1):
            mi, mj = mirror_cell(n, i, j)
            p, q = tab[i - 1][j - 1]
            mp, mq = tab[mi - 1][mj - 1]
            if (p, q) != (mq, mp):
                return False
    return True


def check_antidiagonal_structure(n: int) -> bool:
    """Claim 3: fixed subscript alternates with anti-diagonal parity.

    Even d = i+j fixes the first subscript, odd d fixes the second; the fixed
    value is d-1 for d <= n+1 and 2n+2-d beyond.
    """
    tab = sigma_table(n)
    for i in range(1, n + 1):
        for j in range(1, n + 1):
            d = i + j
            p, q = tab[i - 1][j - 1]
            fixed = d - 1 if d <= n + 1 else 2 * n + 2 - d
            if d % 2 == 0:
                if p != fixed:
                    return False
            else:
                if q != fixed:
                    return False
    return True


def symmetric_readout_schedule(n: int) -> Dict[Tuple[int, int], Tuple[Tuple[int, int], int]]:
    """For each product entry (p, q): the cell to read it from and the step.

    Assumes C is symmetric, so c_pq may be read from the cell holding c_qp.
    Returns {(p, q): ((i, j), step)} using the anti-diagonal start model
    (the model under which the paper's 3n/2-ish claim holds — DESIGN.md).
    """
    times = mesh_completion_times(n, "antidiagonal")
    out: Dict[Tuple[int, int], Tuple[Tuple[int, int], int]] = {}
    for p in range(1, n + 1):
        for q in range(1, n + 1):
            best_cell, best_t = None, None
            for pp, qq in {(p, q), (q, p)}:
                cell = scrambled_cell_of(n, pp, qq)
                t = int(times[cell[0] - 1, cell[1] - 1])
                if best_t is None or t < best_t:
                    best_cell, best_t = cell, t
            out[(p, q)] = (best_cell, best_t)
    return out


def symmetric_readout_steps(n: int) -> int:
    """Worst-case step at which the last distinct value of a symmetric product
    becomes readable.  Empirically floor(3n/2); paper bound n+1+n/2."""
    return max(t for _, t in symmetric_readout_schedule(n).values())


def paper_symmetric_bound(n: int) -> int:
    """The paper's claimed bound: 'the integer less than or equal to n+1+n/2'."""
    return n + 1 + n // 2


def general_readout_steps(n: int) -> int:
    """Readout horizon without symmetry: all cells done, = 2n-1."""
    return int(mesh_completion_times(n, "antidiagonal").max())
