"""Work counts of the kernels whose rooflines the benchmark reports, from
the cell's shapes alone, so they read the same whatever implements them."""

from __future__ import annotations

FLOAT = 4  # bytes of a float32 or an int32

# The nearest-representative assignment scores every moving point against
# every representative: an 8-lane score in the bf16x3 split (three 15-op
# lane products, 2 adds), the scaled subtraction and the compare.
ASSIGN_OPS_PER_PAIR = 50


def nearest_rep_assignment(m: int, n_r: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one assignment of m moving points to
    n_r representatives with per-representative counts: the (m, 8) points,
    the (8, n_r) folded transform and the (n_r,) row read once, the (m,)
    ids and (n_r,) counts written once."""
    ops = ASSIGN_OPS_PER_PAIR * m * n_r
    nbytes = FLOAT * (8 * m + 8 * n_r + n_r + m + n_r)
    return float(ops), float(nbytes)
