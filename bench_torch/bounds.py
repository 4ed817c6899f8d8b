"""Bytes and operations that a function needs, from its shapes."""
from __future__ import annotations


def mv_bound(num_rows: int, num_cols: int, nnz: int) -> tuple:
    """(bytes, ops) of the sparse y = A x as a function, the same for every
    layout of one matrix: each stored entry's 4 B value and 4 B column,
    one 4 B row word a row (CSR's row pointer), x read once and y written
    once; a multiply and an add an entry. A form that stores an entry in
    fewer than 8 B can read above this bound's roofline."""
    return (8 * nnz + 4 * (num_rows + 1) + 4 * num_cols + 4 * num_rows,
            2 * nnz)
