"""Bytes that a boolean function needs, from its shapes."""
from __future__ import annotations


def logical_mv_bytes(num_rows: int, num_cols: int, nnz: int) -> int:
    """Bytes of the value-free boolean y = A x as a function (the logical
    semiring over a matrix whose stored values are all nonzero, so no
    value is read): each stored entry's 4 B column, one 4 B row word a
    row (CSR's row pointer), x read once and y written once, 4 B each."""
    return 4 * nnz + 4 * (num_rows + 1) + 4 * num_cols + 4 * num_rows
