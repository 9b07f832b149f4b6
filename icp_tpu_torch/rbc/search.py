"""Random-Ball-Cover search (port of ``icp_tpu.rbc.search``): the nearest
representative, then an exhaustive search of its bin.

The fused pipelines, per iteration: K1 assigns every raw moving row to its
nearest representative under the accumulated transform and counts the bins,
the grouping sorts the rows bin-major and K2 tables them, and one kernel
searches each bin and reduces it to 8x8 moment matrices: K3 for POINT (the
Horn inputs), K7 for PLANE / GICP (the Gauss-Newton system). With an
adaptive robust scale, K4 first returns every slot's squared NN distance
and their median sets the scale, on the device. Nothing per point comes
back after the grouping.

The unfused pipeline (:func:`rbc_search_grouped`) takes already transformed
queries, assigns them to representatives with one float32 product, groups
them (K2) and searches every bin with K5, returning per-slot matches in the
grouped layout for the per-pair tail of ``icp.step``. :func:`rbc_search`
scatters the same search back to the original query order, with the
overflow / empty-bin fallback to the representative's own point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.kernels.bin_search import bin_search
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
    rep_assign,
    rep_assign_counts,
)
from icp_tpu_torch.ops.distance import metric_weights, pairwise_sq_dists
from icp_tpu_torch.ops.moments import adaptive_robust_delta
from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.grouping import group_by_bin, group_rows_by_bin


class GroupedSearchResult(NamedTuple):
    """NN results in the bin-grouped (permuted) query order, which the
    per-pair reductions consume as they are.

    Attributes:
      queries_g: (n_r, cq, 8) grouped queries (padded slots undefined).
      matched_g: (n_r, cq, 8) matched fixed point of each slot.
      dist_g: (n_r, cq) blended squared distances (0 where not valid).
      valid: (n_r, cq) bool, a real query and a non-empty bin.
      n_dropped: 0-d int tensor, queries not represented (capacity overflow
        or empty bin); stays on the device.
      matched_normals: (n_r, cq, 3) matched fixed normals (zeros without
        normals).
      extra_g: (n_r, cq, k) per-query side rows grouped with the queries
        (e.g. rotated moving normals); (n_r, cq, 0) when unused.
    """

    queries_g: torch.Tensor
    matched_g: torch.Tensor
    dist_g: torch.Tensor
    valid: torch.Tensor
    n_dropped: torch.Tensor
    matched_normals: torch.Tensor
    extra_g: torch.Tensor


def bin_phase2(bins: torch.Tensor, bins_centered: torch.Tensor,
               sq_b_masked: torch.Tensor, bin_normals: torch.Tensor | None,
               qg_w: torch.Tensor, *, with_normals: bool):
    """Per-bin exhaustive search of grouped, weighted, rep-centered queries
    (K5).

    Args:
      bins: (n_b, cb, 8) bin members (original coordinates).
      bins_centered: (n_b, cb, 8) rep-centered bin members.
      sq_b_masked: (n_b, cb) masked |b|^2 (+inf on invalid slots).
      bin_normals: (n_b, cb, 3) member normals (read with ``with_normals``).
      qg_w: (n_b, cq, 8) metric-weighted rep-centered grouped queries.
    Returns:
      (best_score (n_b, cq), +inf where the bin is empty; matched_g
       (n_b, cq, 8); matched_n (n_b, cq, 3)).
    """
    if with_normals:
        # Points and normals (padded to 12 lanes) as one payload: one copy
        # fetches both for the winner.
        vals = torch.cat([bins, bin_normals,
                          bins.new_zeros(bins.shape[:2] + (1,))], dim=-1)
    else:
        vals = bins.contiguous()
    best_score, matched = bin_search(qg_w.contiguous(), bins_centered.contiguous(),
                                     sq_b_masked.contiguous(), vals)
    matched_g = matched[..., :8]
    matched_n = (matched[..., 8:11] if with_normals
                 else matched.new_zeros(matched.shape[:2] + (3,)))
    return best_score, matched_g, matched_n


def rbc_search_grouped(index: RBCIndex, queries: torch.Tensor, alpha,
                       query_capacity: int, with_normals: bool = False,
                       extra_rows: torch.Tensor | None = None
                       ) -> GroupedSearchResult:
    """RBC search with the results left in the grouped layout (the unfused
    step's search).

    Args:
      index: RBC structure over the fixed set (with normals when
        ``with_normals``).
      queries: (m, 8) transformed moving landmarks.
      alpha: photometric blend.
      query_capacity: per-bin query capacity.
      with_normals: also return each match's fixed-surface normal.
      extra_rows: optional (m, k) per-query rows grouped with the queries.
    """
    n_r = index.reps.shape[0]
    d2_qr = pairwise_sq_dists(queries, index.reps, alpha)
    query_rep = torch.argmin(d2_qr, dim=1).to(torch.int32)
    if extra_rows is None:
        extra_rows = queries.new_zeros((queries.shape[0], 0))
    glayout = group_rows_by_bin(query_rep, n_r, query_capacity,
                                (queries, extra_rows))
    queries_g, extra_g = glayout.grouped
    qc = queries_g - index.reps[:, None, :]  # per-bin centering
    w8 = metric_weights(alpha, queries.dtype, queries.device)
    qg_w = qc * w8
    sq_q = torch.sum(qg_w * qc, dim=-1)
    best_score, matched_g, matched_n = bin_phase2(
        index.bins, index.bins_centered, index.sq_b_masked, index.bin_normals,
        qg_w, with_normals=with_normals)
    best_d2 = torch.clamp(best_score + sq_q, min=0.0)
    valid = glayout.valid & torch.isfinite(best_score)
    n_dropped = queries.shape[0] - torch.sum(valid.to(torch.int32))
    return GroupedSearchResult(
        queries_g=queries_g,
        matched_g=matched_g,
        dist_g=torch.where(valid, best_d2, torch.zeros_like(best_d2)),
        valid=valid,
        n_dropped=n_dropped,
        matched_normals=matched_n,
        extra_g=extra_g,
    )


def rbc_point_assign(index: RBCIndex, moving8: torch.Tensor,
                     q: torch.Tensor, t: torch.Tensor, s: torch.Tensor, alpha):
    """Fused transform + nearest representative (K1′), the first phase of
    the two-phase POINT pipeline for callers that group and reduce
    themselves.

    Returns (rid (m,) int32, G (8, 8), b_row (1, 8)); the similarity
    factors are returned for the moments phase.
    """
    G, b_row = prep_similarity(q, t, s)
    C, srow = prep_rep_assign(index.reps, alpha, G, b_row)
    return rep_assign(moving8, C.contiguous(), srow), G.contiguous(), b_row


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


class SearchResult(NamedTuple):
    """NN results in the original query order.

    Attributes:
      nn_id: (m,) int32 database index of each query's match.
      nn_dist: (m,) blended squared distance to the match.
      query_rep: (m,) int32 representative of each query.
      fallback: (m,) bool, True where the overflow / empty-bin fallback
        (the representative's own database point) was used.
    """

    nn_id: torch.Tensor
    nn_dist: torch.Tensor
    query_rep: torch.Tensor
    fallback: torch.Tensor


def rbc_search(index: RBCIndex, queries: torch.Tensor, alpha,
               query_capacity: int) -> SearchResult:
    """In-bin nearest neighbour of each (m, 8) transformed query, in the
    original order (a diagnostic path; the step uses
    :func:`rbc_search_grouped`). The per-bin scores are one float32 batched
    product, as the JAX package computes them outside any kernel."""
    m = queries.shape[0]
    n_r = index.reps.shape[0]
    d2_qr = pairwise_sq_dists(queries, index.reps, alpha)
    query_rep = torch.argmin(d2_qr, dim=1).to(torch.int32)
    d2_to_rep = torch.amin(d2_qr, dim=1)

    qlayout = group_by_bin(query_rep, n_r, query_capacity)
    member = qlayout.member.long()
    qgroups = queries[member] - index.reps[:, None, :]
    w8 = metric_weights(alpha, queries.dtype, queries.device)
    qg_w = qgroups * w8
    sq_q = torch.sum(qg_w * qgroups, dim=-1)
    cross = torch.einsum("rqd,rcd->rqc", qg_w, index.bins_centered)
    score = index.sq_b_masked[:, None, :] - 2.0 * cross
    best_slot = torch.argmin(score, dim=-1)
    best_sc = torch.gather(score, -1, best_slot[..., None])[..., 0]
    fin = torch.isfinite(best_sc)
    best_d2 = torch.where(fin, torch.clamp(best_sc + sq_q, min=0.0),
                          torch.full_like(best_sc, float("inf")))
    best_id = torch.gather(index.bin_ids, -1, best_slot).to(torch.int32)

    # Scatter back; slot m of the (m + 1)-long targets takes (and drops)
    # every invalid slot.
    found = qlayout.valid & fin
    scatter_to = torch.where(qlayout.valid, member, m).reshape(-1)
    fallback_id = index.rep_db_ids[query_rep.long()]

    def scatter(base, grouped):
        out = torch.cat([base, base[:1]])
        out[scatter_to] = grouped.reshape(-1)
        return out[:m]

    nn_id = scatter(fallback_id,
                    torch.where(found, best_id, fallback_id[member]))
    nn_dist = scatter(d2_to_rep, torch.where(found, best_d2, d2_to_rep[member]))
    used_fallback = scatter(torch.ones((m,), dtype=torch.bool, device=queries.device),
                            torch.logical_not(found))
    return SearchResult(nn_id, nn_dist, query_rep, used_fallback)
