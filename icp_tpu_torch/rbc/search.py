"""RBC search, the fused pipelines (port of the fused part of
``icp_tpu.rbc.search``).

Per iteration: K1 assigns every raw moving row to its nearest
representative under the accumulated transform and counts the bins, the
grouping sorts the rows bin-major and K2 tables them, and one kernel
searches each bin and reduces it to 8x8 moment matrices: K3 for POINT (the
Horn inputs), K7 for PLANE / GICP (the Gauss-Newton system). With an
adaptive robust scale, K4 first returns every slot's squared NN distance
and their median sets the scale, on the device. Nothing per point comes
back after the grouping.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels.fused_gn import (
    bin_gn_moments,
    gicp_const_moment,
    gn_v_total,
)
from icp_tpu_torch.kernels.fused_step import (
    bin_min_dists,
    bin_point_moments,
    point_moments_from_P,
    prep_rep_assign,
    prep_similarity,
    rep_assign_counts,
)
from icp_tpu_torch.ops.moments import adaptive_robust_delta
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
                              weighted: bool, robust: str = "none",
                              robust_delta=0.0):
    """Per-bin search + weighting + moments over an already-grouped query
    table -> (S11 (11,), mean_f (3,), mean_m (3,), sum_w)."""
    P = bin_point_moments(mg, qvalid, index.reps, index.bins_centered,
                          index.sq_b_masked, G, b_row, alpha,
                          weighted=weighted, robust=robust,
                          robust_delta=robust_delta)
    return point_moments_from_P(P, index.reps, c, index.moment_w)


def rbc_min_dists_grouped(index: RBCIndex, mg: torch.Tensor,
                          qvalid: torch.Tensor, G: torch.Tensor,
                          b_row: torch.Tensor, alpha) -> torch.Tensor:
    """Blended squared NN distance per grouped query slot, +inf where
    invalid (K4): the adaptive-robust first pass. Queries dropped by the
    query capacity hold no slot and do not enter the median, the same drop
    the moment kernels apply."""
    return bin_min_dists(mg, qvalid, index.reps, index.bins_centered,
                         index.sq_b_masked, G, b_row, alpha)


def _adaptive_delta_grouped(d2: torch.Tensor, robust: str) -> torch.Tensor:
    return adaptive_robust_delta(d2.reshape(-1), torch.isfinite(d2).reshape(-1),
                                 robust)


def _assign_and_group(index: RBCIndex, rows: tuple, q, t, s, alpha,
                      query_capacity: int):
    """K1 + grouping of ``rows`` (moving8 first) -> (grouped tables, qvalid,
    G, b_row)."""
    moving8 = rows[0]
    rid, counts, G, b_row = rbc_point_assign_counts(index, moving8, q, t, s,
                                                    alpha)
    glayout = group_rows_by_bin(rid, index.reps.shape[0], query_capacity, rows,
                                counts=counts)
    return glayout.grouped, glayout.valid.to(moving8.dtype), G, b_row


def rbc_point_moments(index: RBCIndex, moving8: torch.Tensor,
                      q: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
                      alpha, c, query_capacity: int, *, weighted: bool,
                      robust: str = "none", robust_delta=0.0,
                      robust_adaptive: bool = False):
    """Fully fused POINT iteration front half.

    Args:
      index: RBC structure over the fixed set.
      moving8: (m, 8) RAW moving landmarks (the transform is applied in the
        kernels).
      q, t, s: accumulated similarity.
      alpha, c: metric blend / S-matrix scaling.
      query_capacity: per-bin query capacity.
      weighted: reference WEIGHTED vs REGULAR.
      robust, robust_delta: optional robust factor on the pair weights.
      robust_adaptive: derive the robust scale from this iteration's median
        residual (K4), overriding robust_delta.
    Returns:
      (S11 (11,) with c applied, mean_f (3,), mean_m (3,), sum_w scalar).
    """
    (mg,), qvalid, G, b_row = _assign_and_group(index, (moving8,), q, t, s,
                                                alpha, query_capacity)
    if robust_adaptive and robust != "none":
        robust_delta = _adaptive_delta_grouped(
            rbc_min_dists_grouped(index, mg, qvalid, G, b_row, alpha), robust)
    return rbc_point_moments_grouped(index, mg, qvalid, G, b_row, alpha, c,
                                     weighted=weighted, robust=robust,
                                     robust_delta=robust_delta)


def rbc_gn_system(index: RBCIndex, moving8: torch.Tensor, q: torch.Tensor,
                  t: torch.Tensor, s: torch.Tensor, alpha,
                  query_capacity: int, *, mode: str, weighted: bool,
                  robust: str = "none", robust_delta=0.0,
                  robust_adaptive: bool = False, gicp_eps=0.0,
                  mnormals_rot: torch.Tensor | None = None) -> torch.Tensor:
    """Fully fused PLANE / GICP iteration front half: K1, grouping, [K4],
    K7, then the per-bin moments moved to the common frame.

    Args:
      index: RBC structure built with normals (``bins_vals12``, ``gn_w``).
      moving8: (m, 8) RAW moving landmarks.
      q, t, s: accumulated similarity.
      alpha: metric blend.
      query_capacity: per-bin query capacity.
      mode: "plane" | "plane_sym" | "gicp".
      weighted, robust, robust_delta, robust_adaptive: residual weighting.
      gicp_eps: disk-covariance thickness ("gicp").
      mnormals_rot: (m, 3) moving normals rotated into the fixed frame
        ("plane_sym" / "gicp"), grouped alongside the queries.
    Returns:
      V (8, 8), the global GN moment matrix: feed
      ``kernels.fused_gn.gn_system_from_V``, then
      ``icp.plane.solve_plane_system``.
    """
    if index.bins_vals12 is None:
        raise ValueError("rbc_gn_system needs an index built with normals")
    rows = (moving8,) if mode == "plane" else (moving8, mnormals_rot)
    grouped, qvalid, G, b_row = _assign_and_group(index, rows, q, t, s, alpha,
                                                  query_capacity)
    mg = grouped[0]
    nm = None if mode == "plane" else grouped[1]
    if robust_adaptive and robust != "none":
        robust_delta = _adaptive_delta_grouped(
            rbc_min_dists_grouped(index, mg, qvalid, G, b_row, alpha), robust)
    P = bin_gn_moments(mg, nm, qvalid, index.reps, index.bins_vals12,
                       index.sq_b_masked, G, b_row, alpha, mode=mode,
                       weighted=weighted, robust=robust,
                       robust_delta=robust_delta, gicp_eps=gicp_eps)
    if mode == "gicp":
        # The kernel emits the two data rows' moment and the z-moment; the
        # isotropic I/2 block is linear in the z-moment.
        P, P_z = P
        P = P + gicp_const_moment(P_z)
    return gn_v_total(P, index.reps, index.gn_w)
