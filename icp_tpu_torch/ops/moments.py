"""Residual weights, the robust M-estimator scale and the per-pair moments
of the unfused pipeline (port of ``icp_tpu.ops.moments``).

:func:`compute_weights` is the reference's ``icpComputeReduceWeights``;
:func:`robust_factor` the IRLS factor of the optional robust kernel (it
multiplies into the reference weight inside K3, K7 and their twins);
:func:`adaptive_robust_delta` derives the robust scale from the median
residual of the current iteration, on the device, and
:func:`adaptive_robust_delta_sharded` the same scale across the ranks of a
mesh. :func:`centroids`,
:func:`deviations` and :func:`s_matrix` are the POINT tail of the unfused
step (the fused path computes the same sums inside K3).
"""

from __future__ import annotations

import torch

ROBUST_KINDS = ("none", "huber", "tukey", "trimmed")

# Per-kernel multiples of median(|r|) for the adaptive scale: Huber's
# c = 1.345 sigma and Tukey's c = 4.685 sigma with sigma ~ 1.4826 median(|r|)
# give ~2 and ~7; TRIMMED at 3x rejects the gross tail.
_ADAPTIVE_K = {"huber": 2.0, "tukey": 7.0, "trimmed": 3.0}


def compute_weights(dists: torch.Tensor) -> torch.Tensor:
    """Correspondence weights ``w_i = 100 / (100 + d_i)`` of the blended
    squared NN distances ``d_i``."""
    return 100.0 / (100.0 + dists)


def robust_factor(d2: torch.Tensor, kind: str, delta) -> torch.Tensor:
    """IRLS weight of a robust M-estimator on the blended squared distance.

    ``delta`` is in blended distance units (d^2 is compared against
    delta^2): Huber ``min(1, delta / |r|)``, Tukey ``(1 - d^2/delta^2)_+^2``,
    TRIMMED ``d^2 <= delta^2``; "none" gives ones.
    """
    if kind == "none":
        return torch.ones_like(d2)
    if kind not in ROBUST_KINDS:
        raise ValueError(f"unknown robust kernel: {kind!r}")
    delta = torch.as_tensor(delta, dtype=d2.dtype, device=d2.device)
    d2 = torch.clamp(d2, min=0.0)
    if kind == "huber":
        # Exact 1 at r = 0 through the rsqrt guard.
        return torch.clamp(delta * torch.rsqrt(torch.clamp(d2, min=1e-12)), max=1.0)
    if kind == "tukey":
        z = torch.clamp(1.0 - d2 / (delta * delta), min=0.0)
        return z * z
    return (d2 <= delta * delta).to(d2.dtype)


def masked_median(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Lower median of ``x`` over ``mask``, 0 when nothing is valid.

    One sort (invalid entries sort to +inf) and a gather at the device-side
    index (count - 1) // 2: the host never reads a value.
    """
    x = x.reshape(-1)
    if mask is not None:
        mask = mask.reshape(-1)
        x = torch.where(mask, x, torch.full_like(x, float("inf")))
        cnt = torch.sum(mask.to(torch.int64))
    else:
        cnt = torch.full((), x.numel(), dtype=torch.int64, device=x.device)
    s, _ = torch.sort(x)
    med = torch.gather(s, 0, (torch.clamp(cnt - 1, min=0) // 2).reshape(1))[0]
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def adaptive_robust_delta(d2: torch.Tensor, mask: torch.Tensor | None,
                          kind: str) -> torch.Tensor:
    """Per-iteration robust scale ``K_kind * sqrt(median(d2))`` over the valid
    pairs, floored at 1e-3 so an all-zero residual set keeps its weights."""
    med_r = torch.sqrt(torch.clamp(masked_median(d2, mask), min=0.0))
    return torch.clamp(_ADAPTIVE_K[kind] * med_r, min=1e-3)


def masked_median_sharded(x: torch.Tensor, mask: torch.Tensor | None, axes,
                          mesh, bins: int = 256) -> torch.Tensor:
    """Global lower median of ``x`` over ``mask`` across the ranks of
    ``mesh``'s ``axes``, with two collectives instead of a gather of the
    residuals:

      1. one ``pmin`` of (local median, -local median) brackets the global
         median: at least half of every rank's valid mass sits on each side
         of its local median, so the global median lies in
         ``[min_r med_r, max_r med_r]``;
      2. one ``psum`` of the valid count, a ``bins``-bin histogram of the
         valid values over that interval and the count below it locates the
         global rank (count - 1) // 2 to within (hi - lo) / bins.

    The histogram is a product with the one-hot bin matrix: its sums are
    integers, exact in float32 in any order (a float scatter-add on CUDA
    would sum in atomic order). Exact (the shared value) when every rank's
    local median agrees; 0 when no rank has a valid element. Every rank
    returns the same bits.
    """
    x = x.reshape(-1)
    m = (torch.ones(x.shape, dtype=torch.bool, device=x.device) if mask is None
         else mask.reshape(-1))
    cnt_l = torch.sum(m.to(x.dtype))
    med_l = masked_median(x, m)
    has = cnt_l > 0
    inf = torch.full_like(med_l, float("inf"))
    lo_neg_hi = mesh.pmin(torch.stack([torch.where(has, med_l, inf),
                                       torch.where(has, -med_l, inf)]), axes)
    lo, hi = lo_neg_hi[0], -lo_neg_hi[1]

    width = torch.clamp(hi - lo, min=0.0)
    # Bin of every valid element inside [lo, hi] (clipped); the elements
    # below lo go into the rank offset.
    scale = torch.where(width > 0, bins / width, torch.zeros_like(width))
    xi = torch.clamp(((x - lo) * scale).to(torch.int32), 0, bins - 1)
    in_interval = (m & (x >= lo)).to(x.dtype)
    one_hot = (xi[:, None] == torch.arange(bins, dtype=torch.int32,
                                           device=x.device)).to(x.dtype)
    hist_l = in_interval @ one_hot
    below_l = torch.sum((m & (x < lo)).to(x.dtype))
    sums = mesh.psum(torch.cat([cnt_l.reshape(1), below_l.reshape(1), hist_l]), axes)
    total, below, hist = sums[0].to(torch.int64), sums[1], sums[2:]

    k = torch.clamp(total - 1, min=0) // 2  # 0-based lower-median rank
    cum = below + torch.cumsum(hist, dim=0)
    bin_idx = torch.argmax((cum > k.to(x.dtype)).to(torch.int32))  # first covering bin
    est = lo + (bin_idx.to(x.dtype) + 0.5) * (width / bins)
    est = torch.where(width > 0, est, lo)  # every local median agrees: exact
    return torch.where(total > 0, est, torch.zeros_like(est))


def adaptive_robust_delta_sharded(d2: torch.Tensor, mask: torch.Tensor | None,
                                  kind: str, axes, mesh) -> torch.Tensor:
    """:func:`adaptive_robust_delta` across the ranks of ``mesh``'s ``axes``:
    the median comes from :func:`masked_median_sharded`, so every rank
    derives the same robust scale."""
    med_r = torch.sqrt(torch.clamp(masked_median_sharded(d2, mask, axes, mesh), min=0.0))
    return torch.clamp(_ADAPTIVE_K[kind] * med_r, min=1e-3)


def masked_weight_sum(weights: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of the weights, masked entries counting 0."""
    return torch.sum(_masked(weights, mask))


def _masked(weights: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    return weights if mask is None else torch.where(
        mask, weights, torch.zeros_like(weights))


def centroids(fixed8: torch.Tensor, moving8: torch.Tensor,
              weights: torch.Tensor | None = None,
              sum_w: torch.Tensor | None = None,
              mask: torch.Tensor | None = None):
    """xyz centroids (mean_f (3,), mean_m (3,)) of the matched fixed and the
    moving points.

    Without weights the reference's ``icpMean`` (mean over the valid rows,
    at least 1); with weights ``icpMean_Weighted``, sum (w_i / sum_w) x_i,
    where ``sum_w`` is the precomputed sum of the masked weights.
    """
    f = fixed8[..., :3]
    m = moving8[..., :3]
    if weights is None:
        if mask is None:
            return torch.mean(f, dim=0), torch.mean(m, dim=0)
        valid = mask.to(f.dtype)
        n = torch.clamp(torch.sum(valid), min=1.0)
        return (torch.sum(f * valid[:, None], dim=0) / n,
                torch.sum(m * valid[:, None], dim=0) / n)
    w = _masked(weights, mask)
    # Fully-masked-frame guard (sensor dropout): 0/0 would put a NaN into
    # the state that poisons every following iteration.
    safe_w = torch.where(sum_w > 0, sum_w, torch.ones_like(sum_w))
    wn = (w / safe_w)[:, None]
    return torch.sum(f * wn, dim=0), torch.sum(m * wn, dim=0)


def centroid_partials(fixed8: torch.Tensor, moving8: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None):
    """(sum_f (3,), sum_m (3,), denom): partial sums whose ratio over all
    shards is the centroid of :func:`centroids`."""
    f = fixed8[..., :3]
    m = moving8[..., :3]
    if weights is None:
        if mask is None:
            denom = torch.full((), f.shape[0], dtype=f.dtype, device=f.device)
            return torch.sum(f, dim=0), torch.sum(m, dim=0), denom
        w = mask.to(f.dtype)
    else:
        w = _masked(weights, mask)
    return (torch.sum(f * w[:, None], dim=0), torch.sum(m * w[:, None], dim=0),
            torch.sum(w))


def deviations(points8: torch.Tensor, mean3: torch.Tensor) -> torch.Tensor:
    """xyz deviations from a centroid (``icpSubtractMean``)."""
    return points8[..., :3] - mean3


def s_matrix(dev_m: torch.Tensor, dev_f: torch.Tensor, c,
             weights: torch.Tensor | None = None,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """The (11,) S vector of the rotation solve (``icpSijProducts``):
    S[3i+j] = sum_k w_k (c m_k,i)(c f_k,j), S[9] = sum_k w_k |c f_k|^2 and
    S[10] = sum_k w_k |c m_k|^2; ``c`` keeps mm-scale products in float32
    range and cancels in the scale. The 3x3 block is one float32 product
    (TF32 is off in this package)."""
    cm = dev_m * c
    cf = dev_f * c
    if weights is not None:
        w = _masked(weights, mask)
    elif mask is not None:
        w = mask.to(cm.dtype)
    else:
        w = None
    if w is None:
        S3 = cm.T @ cf
        ff = torch.sum(cf * cf)
        mm = torch.sum(cm * cm)
    else:
        S3 = (cm * w[:, None]).T @ cf
        ff = torch.sum(w * torch.sum(cf * cf, dim=-1))
        mm = torch.sum(w * torch.sum(cm * cm, dim=-1))
    return torch.cat([S3.reshape(9), ff.reshape(1), mm.reshape(1)])
