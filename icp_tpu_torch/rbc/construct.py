"""Random-Ball-Cover construction over the fixed set (port of
``icp_tpu.rbc.construct``).

1. point -> representative blended 8-D distances (one (n, 8) x (8, n_r)
   float32 product),
2. each point assigned to its nearest representative,
3. per-representative counts and offsets,
4. the database grouped bin-major into a padded (n_r, capacity, 8) table,

plus the search-time invariants hoisted out of the iteration loop: the
rep-centered bins, the masked |b|^2 row and the moment-translation tensor;
with fixed-surface normals (PLANE / GICP) also the grouped normals, the
12-wide payload K7 reads and the GN frame-translation tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from icp_tpu_torch.kernels.fused_gn import gn_translation_tensor
from icp_tpu_torch.kernels.fused_step import point_translation_tensor
from icp_tpu_torch.ops.distance import metric_weights, pairwise_sq_dists
from icp_tpu_torch.rbc.grouping import GroupedRows, group_rows_by_bin


@dataclasses.dataclass
class RBCIndex:
    """The RBC data structure over the fixed set.

    Attributes:
      reps: (n_r, 8) representatives.
      rep_db_ids: (n_r,) int32 database index of each representative (the
        search's overflow/empty-bin fallback match).
      db: (n, 8) the fixed landmarks.
      rep_id: (n,) int32 nearest representative of each database point.
      layout: bin-major grouping of the database.
      bins: (n_r, capacity, 8) padded per-representative point bins.
      bin_ids: (n_r, capacity) int32 database index per bin slot.
      bin_mask: (n_r, capacity) bool slot validity.
      bins_centered: (n_r, capacity, 8) bins minus their representative.
      sq_b_masked: (n_r, capacity) |b_c|^2_w, +inf on invalid slots and on
        zero-geometry database points.
      alpha: 0-d photometric blend the index was built with.
      moment_w: (n_r, 8, 8, 18) hoisted POINT moment-translation tensor.
      normals: (n, 3) fixed-surface normals, or None.
      bin_normals: (n_r, capacity, 3) normals grouped with the bins, or None.
      bins_vals12: (n_r, capacity, 12) ``[bins_centered | bin_normals | 0]``,
        the payload of K7, or None.
      gn_w: (n_r, 8, 8, 64) hoisted GN frame-translation tensor, or None.
    """

    reps: torch.Tensor
    rep_db_ids: torch.Tensor
    db: torch.Tensor
    rep_id: torch.Tensor
    layout: GroupedRows
    bins: torch.Tensor
    bin_ids: torch.Tensor
    bin_mask: torch.Tensor
    bins_centered: torch.Tensor
    sq_b_masked: torch.Tensor
    alpha: torch.Tensor
    moment_w: torch.Tensor
    normals: torch.Tensor | None = None
    bin_normals: torch.Tensor | None = None
    bins_vals12: torch.Tensor | None = None
    gn_w: torch.Tensor | None = None


def rbc_construct(db: torch.Tensor, reps: torch.Tensor, alpha,
                  capacity: int,
                  rep_db_ids: torch.Tensor | None = None,
                  normals: torch.Tensor | None = None) -> RBCIndex:
    """Build the RBC structure.

    Args:
      db: (n, 8) float32 fixed landmarks.
      reps: (n_r, 8) representatives.
      alpha: photometric blend of the 8-D metric.
      capacity: per-bin capacity; points ranked past it in their bin are
        dropped from the bin (they stay in ``db`` and ``rep_id``).
      rep_db_ids: optional (n_r,) database indices of the representatives;
        else the nearest database point of each representative.
      normals: optional (n, 3) fixed-surface normals (PLANE / GICP),
        grouped in the same payload sort as the points.
    """
    d2 = pairwise_sq_dists(db, reps, alpha)  # (n, n_r)
    rep_id = torch.argmin(d2, dim=1).to(torch.int32)
    if rep_db_ids is None:
        rep_db_ids = torch.argmin(d2, dim=0).to(torch.int32)

    # Database ids ride as a float column (exact up to 2^24 rows), so one
    # permute and one table build group points, ids and normals together.
    ids_col = torch.arange(db.shape[0], dtype=db.dtype, device=db.device)[:, None]
    rows = (db, ids_col) if normals is None else (db, ids_col, normals)
    layout = group_rows_by_bin(rep_id, reps.shape[0], capacity, rows)
    bins, ids_g = layout.grouped[:2]
    bin_ids = ids_g[..., 0].to(torch.int32)

    bins_centered = bins - reps[:, None, :]
    w8 = metric_weights(alpha, db.dtype, db.device)
    sq_b = torch.sum((bins_centered * w8) * bins_centered, dim=-1)
    # Invalid slots and zero-geometry (invalid sensor) database points are
    # masked out of matching: +inf doubles as the search mask.
    nonzero_db = torch.sum(torch.abs(bins[..., :3]), dim=-1) > 0
    sq_b_masked = torch.where(layout.valid & nonzero_db, sq_b,
                              torch.full_like(sq_b, float("inf")))

    gn_fields = {}
    if normals is not None:
        bin_normals = layout.grouped[2]
        gn_fields = dict(
            normals=normals,
            bin_normals=bin_normals,
            bins_vals12=torch.cat([bins_centered, bin_normals,
                                   bins.new_zeros(bins.shape[:2] + (1,))], dim=-1),
            gn_w=gn_translation_tensor(reps))
    return RBCIndex(
        reps=reps,
        rep_db_ids=rep_db_ids,
        db=db,
        rep_id=rep_id,
        layout=layout,
        bins=bins,
        bin_ids=bin_ids,
        bin_mask=layout.valid,
        bins_centered=bins_centered,
        sq_b_masked=sq_b_masked,
        alpha=torch.as_tensor(alpha, dtype=db.dtype, device=db.device),
        moment_w=point_translation_tensor(reps),
        **gn_fields,
    )
