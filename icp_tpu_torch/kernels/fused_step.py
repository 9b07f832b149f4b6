"""The fused POINT-objective hot loop (port of ``icp_tpu.kernels.fused_step``).

Two kernels carry each iteration:

1. :func:`rep_assign_counts` (K1, ``csrc/rep_assign_counts.cu``): the
   accumulated similarity, the metric weights and the representative
   centering fold into an (8, n_r) matrix C and an (n_r,) row srow
   (:func:`prep_rep_assign`), so the nearest representative of a raw moving
   row p is ``argmin_r(srow - 2 p @ C)`` (first minimum on ties), and the
   per-bin counts equal ``bincount(rid)`` exactly. :func:`rep_assign`
   (K1′, the same source) returns rid alone.
2. :func:`bin_point_moments` (K3, ``csrc/bin_point_moments.cu``): per bin,
   transform and center the grouped queries, search the rep-centered bin,
   weight the match (reference weight times the optional robust factor),
   and reduce to one 8x8 matrix ``P_b = sum_i w_i u_i u_i^T`` with
   ``u = [m_c, 1, f_c, 1]``. Its homogeneous lanes make P_b carry every
   statistic of the Horn solve: sum(w) at [3, 3], the centroid sums in
   row/column 3, the cross-covariance at [0:3, 4:7] and the deviation
   energies on the diagonal blocks.

With an adaptive robust scale, :func:`bin_min_dists` (K4,
``csrc/bin_min_dists.cu``) runs the same search first and returns only each
slot's squared NN distance, whose median sets the scale.

The moments are per bin, centered on the representative, which keeps every
product at offset scale; :func:`point_moments_from_P` translates them back to
the common frame with exact algebra over n_r rows.

Each kernel has a plain twin here with the same math (``*_ref``): the CPU
path and the golden of the on-card check. The score contractions reproduce
the JAX package's bf16x3 split (:func:`dot3`), so the argmin decisions are
the reference's. Every value that feeds an argmin (the transform, the
centering, the scores) is computed by the twins in a fixed order with one
IEEE rounding per operation (:func:`lane_dot`), the order the kernels use
too, so kernel and twin make bit-identical argmin decisions on the card: a
different pick at a near-tie would move a bin's moments by ~1e-3 of their
largest entry.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.icp.quaternion import quat_to_matrix
from icp_tpu_torch.kernels import native
from icp_tpu_torch.ops.distance import metric_weights
from icp_tpu_torch.ops.moments import ROBUST_KINDS, robust_factor


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] over the last axis (broadcasting the
    others), accumulated in lane order with a rounding after every multiply
    and every add, as the CUDA kernels compute it."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16x3 lane contraction (the 3-pass float32 emulation) for SCORES.

    a = a_hi + a_lo and b = b_hi + b_lo with every part rounded to bf16
    (round to nearest even); the result is (hi.hi + hi.lo) + lo.hi, every
    product exact in float32. The lo.lo term (~2^-32 relative) is dropped,
    as in ``icp_tpu.kernels.fused_step.dot3``. a and b broadcast against
    each other except in the last (lane) axis.
    """
    a_hi = _bf16_round(a)
    b_hi = _bf16_round(b)
    a_lo = _bf16_round(a - a_hi)
    b_lo = _bf16_round(b - b_hi)
    return (lane_dot(a_hi, b_hi) + lane_dot(a_hi, b_lo)) + lane_dot(a_lo, b_hi)


# ---------------------------------------------------------------------------
# Precomputation (tiny tensor ops; the kernels' constants)
# ---------------------------------------------------------------------------


def prep_similarity(q: torch.Tensor, t: torch.Tensor, s: torch.Tensor):
    """(G (8, 8), b_row (1, 8)) with ``transform_points(p, q, t, s) ==
    p @ G + b_row`` for 8-D row points (lanes 3:8 pass through)."""
    R = quat_to_matrix(q)
    A = torch.eye(8, dtype=R.dtype, device=R.device)
    A[:3, :3] = s * R
    b_row = torch.cat([t, t.new_zeros(5)])[None, :]
    return A.T, b_row


def prep_rep_assign(reps: torch.Tensor, alpha, G: torch.Tensor,
                    b_row: torch.Tensor):
    """Fold transform + metric + centering into the rep-assignment product.

    With ctr = mean(reps), b_c = reps - ctr and w8 the metric weights, the
    blended distance of tp = p @ G + b_row to rep r is, up to a per-query
    constant, ``srow[r] - 2 (p @ C)[r]`` where C = G @ (w8 * b_c)^T and
    srow = |b_c|^2_w - 2 (b_row - ctr) @ (w8 * b_c)^T.

    Returns (C (8, n_r), srow (1, n_r)).
    """
    w8 = metric_weights(alpha, reps.dtype, reps.device)
    ctr = torch.mean(reps, dim=0)
    b_c = reps - ctr
    B = (b_c * w8).T
    srow = (torch.sum(b_c * w8 * b_c, dim=1)[None, :]
            - 2.0 * ((b_row - ctr[None, :]) @ B))
    C = G @ B
    return C, srow


# ---------------------------------------------------------------------------
# K1: transform + nearest representative + per-bin counts (K1′: no counts)
# ---------------------------------------------------------------------------


def rep_assign_ref(moving8: torch.Tensor, C: torch.Tensor,
                   srow: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rep_assign`: rid (m,) int32."""
    scores = srow - 2.0 * dot3(moving8[:, None, :], C.T[None, :, :])
    return torch.argmin(scores, dim=1).to(torch.int32)


def rep_assign(moving8: torch.Tensor, C: torch.Tensor,
               srow: torch.Tensor) -> torch.Tensor:
    """Fused transform + nearest representative; K1′, replacing
    ``icp_tpu.kernels.fused_step.rep_assign_pallas``: K1's kernel with the
    counts compiled out, so its rid equals :func:`rep_assign_counts`'s.

    Args:
      moving8: (m, 8) float32 RAW moving rows (the transform is in C).
      C, srow: from :func:`prep_rep_assign`.
    Returns:
      rid (m,) int32, the first-minimum representative of each row.
    """
    if moving8.device.type == "cpu":
        return rep_assign_ref(moving8, C, srow)
    native.require_cuda(moving8, "moving8")
    dev = moving8.device
    m = moving8.shape[0]
    n_r = C.shape[1]
    native.require(moving8, "moving8", (m, 8), torch.float32, dev)
    native.require_aligned(moving8, "moving8")
    native.require(C, "C", (8, n_r), torch.float32, dev)
    native.require(srow, "srow", (1, n_r), torch.float32, dev)
    rid = torch.empty((m,), dtype=torch.int32, device=dev)
    native.launch("icp_rep_assign", dev, moving8.data_ptr(), C.data_ptr(), srow.data_ptr(),
                  m, n_r, rid.data_ptr())
    return rid


def rep_assign_counts_ref(moving8: torch.Tensor, C: torch.Tensor,
                          srow: torch.Tensor):
    """Plain twin of :func:`rep_assign_counts`: (rid (m,) int32,
    counts (n_r,) int32)."""
    rid = rep_assign_ref(moving8, C, srow)
    counts = torch.bincount(rid, minlength=C.shape[1]).to(torch.int32)
    return rid, counts


def rep_assign_counts(moving8: torch.Tensor, C: torch.Tensor,
                      srow: torch.Tensor):
    """Fused transform + nearest representative + per-bin counts; K1,
    replacing ``icp_tpu.kernels.fused_step.rep_assign_counts_pallas``.

    Args:
      moving8: (m, 8) float32 RAW moving rows (the transform is in C).
      C, srow: from :func:`prep_rep_assign`.
    Returns:
      (rid (m,) int32, counts (n_r,) int32 with ``counts[b] ==
      sum(rid == b)`` exactly).
    """
    if moving8.device.type == "cpu":
        return rep_assign_counts_ref(moving8, C, srow)
    native.require_cuda(moving8, "moving8")
    dev = moving8.device
    m = moving8.shape[0]
    n_r = C.shape[1]
    native.require(moving8, "moving8", (m, 8), torch.float32, dev)
    native.require_aligned(moving8, "moving8")
    native.require(C, "C", (8, n_r), torch.float32, dev)
    native.require(srow, "srow", (1, n_r), torch.float32, dev)
    rid = torch.empty((m,), dtype=torch.int32, device=dev)
    counts = torch.zeros((n_r,), dtype=torch.int32, device=dev)
    native.launch("icp_rep_assign_counts", dev, moving8.data_ptr(), C.data_ptr(),
                  srow.data_ptr(), m, n_r, rid.data_ptr(), counts.data_ptr())
    return rid, counts


# ---------------------------------------------------------------------------
# K3: per-bin search reduced to 8x8 moment matrices
# ---------------------------------------------------------------------------


def device_scalars(dev: torch.device, *values) -> torch.Tensor:
    """(n,) float32 tensor of scalars (floats or 0-d tensors) on ``dev``:
    the kernels read alpha, the robust scale and eps on the device, so an
    adaptive scale computed there never syncs the host. A Python float
    becomes a fill on the device: copying it from host memory would wait
    for the stream."""
    return torch.cat([
        v.to(torch.float32).reshape(1)
        if isinstance(v, torch.Tensor) and v.device == dev
        else torch.full((1,), float(v), dtype=torch.float32, device=dev)
        for v in values])


def robust_kind(robust: str) -> int:
    """Index of a robust kernel name as the CUDA kernels take it."""
    if robust not in ROBUST_KINDS:
        raise ValueError(f"unknown robust kernel: {robust!r}")
    return ROBUST_KINDS.index(robust)


def search_ref(mg: torch.Tensor, qvalid: torch.Tensor, reps: torch.Tensor,
               bins_c: torch.Tensor, sq_b_masked: torch.Tensor,
               G: torch.Tensor, b_row: torch.Tensor, alpha):
    """Plain twin of the kernels' shared per-bin search (``common.cuh``;
    the JAX package's ``_score_core`` + argmin).

    Returns (qc (n_r, cq, 8) transformed rep-centered queries, best_score
    (n_r, cq), best_slot (n_r, cq), sq_q (n_r, cq) = |qc|^2_w, valid0
    (n_r, cq) = qvalid * (original point non-zero)).
    """
    # qc = (p @ G + b_row) - rep: transformed, rep-centered queries.
    off = b_row - reps
    qc = lane_dot(mg[..., None, :], G.T) + off[:, None, :]
    w8 = metric_weights(alpha, mg.dtype, mg.device)
    qg_w = qc * w8
    sq_q = lane_dot(qg_w, qc)
    # +inf rides in sq_b_masked for invalid slots.
    scores = sq_b_masked[:, None, :] - 2.0 * dot3(qg_w[:, :, None, :],
                                                  bins_c[:, None, :, :8])
    best_score, best_slot = torch.min(scores, dim=-1)
    vo = (torch.sum(torch.abs(mg[..., :3]), dim=-1) > 0).to(mg.dtype)
    return qc, best_score, best_slot, sq_q, qvalid * vo


def match_weights_ref(best_score: torch.Tensor, sq_q: torch.Tensor,
                      valid0: torch.Tensor, *, weighted: bool,
                      robust: str = "none", robust_delta=0.0) -> torch.Tensor:
    """The composed pair weight of the JAX package's ``_search_core``:
    validity (slot occupied, original point non-zero, bin non-empty) times
    the reference weight 100/(100+d^2) times the robust factor."""
    w = valid0 * torch.isfinite(best_score).to(valid0.dtype)
    if weighted or robust != "none":
        # +inf on empty bins becomes a clean 0 in every factor below.
        d2 = torch.clamp(best_score + sq_q, min=0.0)
    if weighted:
        w = w * (100.0 / (100.0 + d2))  # reference icpComputeReduceWeights
    if robust != "none":
        w = w * robust_factor(d2, robust, robust_delta)
    return w


def bin_point_moments_ref(mg: torch.Tensor, qvalid: torch.Tensor,
                          reps: torch.Tensor, bins_c: torch.Tensor,
                          sq_b_masked: torch.Tensor, G: torch.Tensor,
                          b_row: torch.Tensor, alpha, *, weighted: bool,
                          robust: str = "none",
                          robust_delta=0.0) -> torch.Tensor:
    """Plain twin of :func:`bin_point_moments` (the math of the JAX
    package's ``_search_core`` / ``_moment_math``)."""
    qc, best_score, best_slot, sq_q, valid0 = search_ref(
        mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, alpha)
    w = match_weights_ref(best_score, sq_q, valid0, weighted=weighted,
                          robust=robust, robust_delta=robust_delta)
    matched = torch.gather(bins_c, 1, best_slot[..., None].expand(-1, -1, 8))
    ones = torch.ones_like(qc[..., :1])
    u = torch.cat([qc[..., :3], ones, matched[..., :3], ones], dim=-1)
    return torch.einsum("bqi,bqj->bij", u * w[..., None], u)


def bin_point_moments(mg: torch.Tensor, qvalid: torch.Tensor,
                      reps: torch.Tensor, bins_c: torch.Tensor,
                      sq_b_masked: torch.Tensor, G: torch.Tensor,
                      b_row: torch.Tensor, alpha, *, weighted: bool,
                      robust: str = "none", robust_delta=0.0) -> torch.Tensor:
    """Fused per-bin search + weighting + 8x8 moment reduction; K3,
    replacing ``icp_tpu.kernels.fused_step.bin_point_moments_pallas``.

    Args:
      mg: (n_r, cq, 8) bin-grouped RAW moving rows.
      qvalid: (n_r, cq) float32 slot validity from the grouping.
      reps: (n_r, 8) representatives.
      bins_c: (n_r, cb, 8) rep-centered bin points.
      sq_b_masked: (n_r, cb) masked |b|^2_w (+inf on invalid slots).
      G, b_row: from :func:`prep_similarity`.
      alpha: photometric blend (float or 0-d tensor).
      weighted: reference WEIGHTED (w = 100/(100+d^2)) vs REGULAR.
      robust: "none" | "huber" | "tukey" | "trimmed"; its IRLS factor
        (``ops.moments.robust_factor``) multiplies into w.
      robust_delta: robust scale (float or 0-d tensor, read on the device).
    Returns:
      (n_r, 8, 8) per-bin moments P_b in the rep-centered frame.
    """
    if mg.device.type == "cpu":
        return bin_point_moments_ref(mg, qvalid, reps, bins_c, sq_b_masked,
                                     G, b_row, alpha, weighted=weighted,
                                     robust=robust, robust_delta=robust_delta)
    native.require_cuda(mg, "mg")
    dev = mg.device
    n_r, cq, _ = mg.shape
    cb = bins_c.shape[1]
    f32 = torch.float32
    native.require(mg, "mg", (n_r, cq, 8), f32, dev)
    native.require(qvalid, "qvalid", (n_r, cq), f32, dev)
    native.require(reps, "reps", (n_r, 8), f32, dev)
    native.require(bins_c, "bins_c", (n_r, cb, 8), f32, dev)
    native.require(sq_b_masked, "sq_b_masked", (n_r, cb), f32, dev)
    native.require(G, "G", (8, 8), f32, dev)
    native.require(b_row, "b_row", (1, 8), f32, dev)
    kind = robust_kind(robust)
    scal = device_scalars(dev, alpha, robust_delta)
    P = torch.empty((n_r, 8, 8), dtype=f32, device=dev)
    native.launch("icp_bin_point_moments", dev, mg.data_ptr(), qvalid.data_ptr(),
                  reps.data_ptr(), bins_c.data_ptr(), sq_b_masked.data_ptr(), G.data_ptr(),
                  b_row.data_ptr(), scal.data_ptr(), n_r, cq, cb, int(weighted), kind,
                  P.data_ptr())
    return P


# ---------------------------------------------------------------------------
# K4: per-bin nearest-neighbour distances only (adaptive robust scale)
# ---------------------------------------------------------------------------


def bin_min_dists_ref(mg: torch.Tensor, qvalid: torch.Tensor,
                      reps: torch.Tensor, bins_c: torch.Tensor,
                      sq_b_masked: torch.Tensor, G: torch.Tensor,
                      b_row: torch.Tensor, alpha) -> torch.Tensor:
    """Plain twin of :func:`bin_min_dists` (the JAX package's
    ``_min_dist_math``)."""
    _, best_score, _, sq_q, valid0 = search_ref(
        mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, alpha)
    d2 = torch.clamp(best_score + sq_q, min=0.0)
    keep = (valid0 > 0) & torch.isfinite(best_score)
    return torch.where(keep, d2, torch.full_like(d2, float("inf")))


def bin_min_dists(mg: torch.Tensor, qvalid: torch.Tensor, reps: torch.Tensor,
                  bins_c: torch.Tensor, sq_b_masked: torch.Tensor,
                  G: torch.Tensor, b_row: torch.Tensor, alpha) -> torch.Tensor:
    """Blended squared NN distance of every grouped query slot, +inf where
    the slot is empty, its original point is zero or its bin has no valid
    point; K4, replacing ``icp_tpu.kernels.fused_step.bin_min_dists_pallas``.

    Arguments as :func:`bin_point_moments`; on CUDA the rows of ``mg`` may
    be lanes 0:8 of a wider grouped table (row stride read from the view).
    Returns (n_r, cq) float32; feed ``ops.moments.adaptive_robust_delta``
    with mask = isfinite.
    """
    if mg.device.type == "cpu":
        return bin_min_dists_ref(mg, qvalid, reps, bins_c, sq_b_masked, G,
                                 b_row, alpha)
    native.require_cuda(mg, "mg")
    dev = mg.device
    n_r, cq, _ = mg.shape
    cb = bins_c.shape[1]
    f32 = torch.float32
    ld_mg = native.require_rows(mg, "mg", (n_r, cq, 8), f32, dev)
    native.require(qvalid, "qvalid", (n_r, cq), f32, dev)
    native.require(reps, "reps", (n_r, 8), f32, dev)
    native.require(bins_c, "bins_c", (n_r, cb, 8), f32, dev)
    native.require(sq_b_masked, "sq_b_masked", (n_r, cb), f32, dev)
    native.require(G, "G", (8, 8), f32, dev)
    native.require(b_row, "b_row", (1, 8), f32, dev)
    scal = device_scalars(dev, alpha)
    d2 = torch.empty((n_r, cq), dtype=f32, device=dev)
    native.launch("icp_bin_min_dists", dev, mg.data_ptr(), ld_mg, qvalid.data_ptr(),
                  reps.data_ptr(), bins_c.data_ptr(), sq_b_masked.data_ptr(), G.data_ptr(),
                  b_row.data_ptr(), scal.data_ptr(), n_r, cq, cb, d2.data_ptr())
    return d2


# ---------------------------------------------------------------------------
# Assembly: per-bin P matrices -> global Horn inputs
# ---------------------------------------------------------------------------


def point_moment_partials(P: torch.Tensor, reps: torch.Tensor,
                          W_t: torch.Tensor | None = None) -> torch.Tensor:
    """Translate per-bin rep-centered moments to common-frame global sums.

    For each bin with rep r (m, f the transformed-moving / matched-fixed
    points, w the weights)::

        sum w m f^T |_bin = smf + sm r^T + r sf^T + s0 r r^T

    With ``W_t`` (:func:`point_translation_tensor`) the same linear map is
    one (1, n_b*64) x (n_b*64, 18) product.

    Returns:
      (18,) [W, Sm(3), Sf(3), Smf(9), Sff, Smm] of pre-mean-subtraction sums.
    """
    if W_t is not None:
        n_b = P.shape[0]
        return (P.reshape(1, n_b * 64) @ W_t.reshape(n_b * 64, 18)).reshape(18)
    r = reps[:, :3]
    s0 = P[:, 3, 3]
    sm = P[:, 0:3, 3]
    sf = P[:, 3, 4:7]
    smf = P[:, 0:3, 4:7]
    smm = P[:, 0, 0] + P[:, 1, 1] + P[:, 2, 2]
    sff = P[:, 4, 4] + P[:, 5, 5] + P[:, 6, 6]

    W = torch.sum(s0)
    Sm = torch.sum(sm + s0[:, None] * r, dim=0)
    Sf = torch.sum(sf + s0[:, None] * r, dim=0)
    Smf = torch.sum(
        smf
        + sm[:, :, None] * r[:, None, :]
        + r[:, :, None] * sf[:, None, :]
        + s0[:, None, None] * (r[:, :, None] * r[:, None, :]),
        dim=0,
    )
    r2 = torch.sum(r * r, dim=1)
    Sff = torch.sum(sff + 2.0 * torch.sum(sf * r, dim=1) + s0 * r2)
    Smm = torch.sum(smm + 2.0 * torch.sum(sm * r, dim=1) + s0 * r2)
    return torch.cat([W.reshape(1), Sm, Sf, Smf.reshape(9),
                      Sff.reshape(1), Smm.reshape(1)])


def point_translation_tensor(reps: torch.Tensor) -> torch.Tensor:
    """(n_b, 8, 8, 18) coefficients W_t of the linear map
    :func:`point_moment_partials` (``sums[k] = sum P[b,i,j] W_t[b,i,j,k]``),
    built once per index with ``torch.func.jacrev`` of the direct algebra so
    the two forms cannot drift apart."""
    jac = torch.func.jacrev(lambda P: point_moment_partials(P, reps))(
        reps.new_zeros((reps.shape[0], 8, 8)))  # (18, n_b, 8, 8)
    return jac.permute(1, 2, 3, 0).contiguous()


def assemble_point_moments(sums: torch.Tensor, c):
    """Horn inputs from the (18,) moment sums: subtract the rank-one mean
    term and apply the c scaling (it cancels in s_k).

    Returns:
      (S11 (11,) in icpSijProducts layout, mean_f (3,), mean_m (3,),
       sum_w scalar).
    """
    W = sums[0]
    Sm = sums[1:4]
    Sf = sums[4:7]
    Smf = sums[7:16].reshape(3, 3)
    Sff = sums[16]
    Smm = sums[17]

    # Fully-masked-frame guard: 0/0 here would poison the state.
    safe_w = torch.where(W > 0, W, torch.ones_like(W))
    mean_m = Sm / safe_w
    mean_f = Sf / safe_w
    S3 = Smf - torch.outer(Sm, Sf) / safe_w
    ff = Sff - torch.sum(Sf * Sf) / safe_w
    mm = Smm - torch.sum(Sm * Sm) / safe_w

    c2 = torch.as_tensor(c, dtype=S3.dtype, device=S3.device) ** 2
    S11 = torch.cat([S3.reshape(9), ff.reshape(1), mm.reshape(1)]) * c2
    return S11, mean_f, mean_m, W


def point_moments_from_P(P: torch.Tensor, reps: torch.Tensor, c,
                         W_t: torch.Tensor | None = None):
    """Per-bin P matrices -> (S11, mean_f, mean_m, sum_w)."""
    return assemble_point_moments(point_moment_partials(P, reps, W_t), c)
