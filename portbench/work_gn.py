"""Work count of the per-bin Gauss-Newton moments (K7), from the cell's
shapes alone, in each of its modes, so that it reads the same whatever
implements it.

K7 searches each moving point's representative's bin for its nearest fixed
point, as K3 does, and reduces the weighted rows of the Gauss-Newton system
of the pairs it keeps to one 8x8 moment a bin. The pairs its inputs hold:
each of the m moving points kept in its bin (at most the query capacity a
bin) against the n / n_r fixed points that a bin holds on average (at most
the bin capacity), 50 float32 operations a pair (``work.py``'s score of K1).
Then, per kept query, the similarity applied to its 8 lanes and the moment
accumulation of its mode's rows; a fused multiply-add counts as two:

* every mode: the 8x8 similarity on 8 lanes (128), the weighted |q|^2 (24),
  the reference weight 100 / (100 + d^2) (3), d = m - f (3);
* "plane": one row v = [n_f, m x n_f, n_f . d, 1] (cross 9, dot 5) and the 36
  distinct entries of w v v^T (a product and a fused multiply-add, 3 each);
* "plane_sym": the same row along n_f + n_m (3 more);
* "gicp": the two rows along n_f + n_m and n_f - n_m (6 + 2 x 14), c = n_f . n_m
  (5), the two row weights e / (4 (2 - e (1 +- c))) and their products with w
  (2 x 5 + 2), the 36 entries of both rows (6 each) and the 28 of the
  z-moment w z z^T, z = [m, d, 1] (3 each).

Bytes: the kernel's inputs read once and its outputs written once: the
grouped moving rows (8 lanes), their moving normals (3 lanes; "plane_sym",
"gicp") and slot validity, the representatives, the bins' rows
(centred point and normal, 12 lanes) and their |b|^2, the similarity (64 +
8), its 3 scalars, and the 8x8 moment a bin (two for "gicp").
"""

from __future__ import annotations

from portbench.reference.icp import capacities
from portbench.work import ASSIGN_OPS_PER_PAIR, FLOAT

GN_MODES = ("plane", "plane_sym", "gicp")
QUERY_OPS = 128 + 24 + 3 + 3
ROW_OPS = {"plane": 14 + 36 * 3, "plane_sym": 3 + 14 + 36 * 3,
           "gicp": 6 + 2 * 14 + 5 + 2 * 5 + 2 + 36 * 6 + 28 * 3}


def gn_mode(icp: dict) -> str:
    """K7's mode of a configuration's ``icp`` section."""
    if icp["objective"] == "gicp":
        return "gicp"
    return "plane_sym" if icp.get("plane_symmetric") else "plane"


def gn_moments(m: int, n: int, n_r: int, mode: str) -> tuple[float, float]:
    """(float32 operations, bytes) of one K7 call: m moving points against
    an index of n fixed points over n_r representatives, in ``mode``."""
    if mode not in GN_MODES:
        raise ValueError(f"mode must be one of {GN_MODES}, got {mode!r}")
    cb, cq = capacities(n, n_r)
    kept = min(m, n_r * cq)
    pairs = kept * min(n / n_r, cb)
    ops = ASSIGN_OPS_PER_PAIR * pairs + kept * (QUERY_OPS + ROW_OPS[mode])
    slots = n_r * cq
    moving = slots * (8 + (3 if mode != "plane" else 0) + 1)
    index = n_r * 8 + n_r * cb * (12 + 1) + 64 + 8 + 3
    out = n_r * 64 * (2 if mode == "gicp" else 1)
    return float(ops), float(FLOAT * (moving + index + out))
