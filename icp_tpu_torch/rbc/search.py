"""RBC search, fused POINT pipeline (port of the main-path part of
``icp_tpu.rbc.search``).

Per iteration: K1 assigns every raw moving row to its nearest
representative under the accumulated transform and counts the bins, the
grouping sorts the rows bin-major and K2 tables them, and K3 searches each
bin and reduces it to an 8x8 moment matrix. Nothing per point comes back
after the grouping; the Horn inputs follow from n_r small matrices.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels.fused_step import (
    bin_point_moments,
    point_moments_from_P,
    prep_rep_assign,
    prep_similarity,
    rep_assign_counts,
)
from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.grouping import group_rows_by_bin


def rbc_point_assign_counts(index: RBCIndex, moving8: torch.Tensor,
                            q: torch.Tensor, t: torch.Tensor,
                            s: torch.Tensor, alpha):
    """Fused transform + nearest representative + per-bin counts.

    Returns (rid (m,) int32, counts (n_r,) int32, G (8, 8), b_row (1, 8));
    the similarity factors are returned for the moments phase.
    """
    G, b_row = prep_similarity(q, t, s)
    C, srow = prep_rep_assign(index.reps, alpha, G, b_row)
    rid, counts = rep_assign_counts(moving8, C.contiguous(), srow)
    return rid, counts, G.contiguous(), b_row


def rbc_point_moments_grouped(index: RBCIndex, mg: torch.Tensor,
                              qvalid: torch.Tensor, G: torch.Tensor,
                              b_row: torch.Tensor, alpha, c, *,
                              weighted: bool):
    """Per-bin search + weighting + moments over an already-grouped query
    table -> (S11 (11,), mean_f (3,), mean_m (3,), sum_w)."""
    P = bin_point_moments(mg, qvalid, index.reps, index.bins_centered,
                          index.sq_b_masked, G, b_row, alpha,
                          weighted=weighted)
    return point_moments_from_P(P, index.reps, c, index.moment_w)


def rbc_point_moments(index: RBCIndex, moving8: torch.Tensor,
                      q: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
                      alpha, c, query_capacity: int, *, weighted: bool):
    """Fully fused POINT iteration front half.

    Args:
      index: RBC structure over the fixed set.
      moving8: (m, 8) RAW moving landmarks (the transform is applied in the
        kernels).
      q, t, s: accumulated similarity.
      alpha, c: metric blend / S-matrix scaling.
      query_capacity: per-bin query capacity.
      weighted: reference WEIGHTED vs REGULAR.
    Returns:
      (S11 (11,) with c applied, mean_f (3,), mean_m (3,), sum_w scalar).
    """
    n_r = index.reps.shape[0]
    rid, counts, G, b_row = rbc_point_assign_counts(index, moving8, q, t, s,
                                                    alpha)
    glayout = group_rows_by_bin(rid, n_r, query_capacity, (moving8,),
                                counts=counts)
    (mg,) = glayout.grouped
    qvalid = glayout.valid.to(moving8.dtype)
    return rbc_point_moments_grouped(index, mg, qvalid, G, b_row, alpha, c,
                                     weighted=weighted)
