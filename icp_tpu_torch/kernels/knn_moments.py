"""The two kernels of the RBC kNN normal estimator (port of
``icp_tpu.kernels.knn_moments``).

1. :func:`rep_top2_counts` (K9, ``csrc/rep_top2_counts.cu``): the first and
   second nearest representative of every raw 3-D point, scored as
   ``srow[r] - 2 dot3(p, r)`` with ``srow = |r|^2`` on the UNCENTRED
   coordinates (the reference's semantics, cancellation included), and the
   exact per-choice bin counts. ``i1`` is the first minimum by id; ``i2``
   the first minimum once the single column ``i1`` is masked.
2. :func:`bin_knn_moments` (K8, ``csrc/bin_knn_moments.cu``): per bin and
   grouped query, the kNN covariance of the query's neighbours among the
   bin's candidates, all centred on the bin's representative. The k-th
   distance is not selected exactly: 18 halvings of a bisection on its
   value give a threshold, and every candidate at or below it enters the
   neighbourhood (ties and near-ties may admit a few more than k). Then
   ``S1 = W b`` and ``M2 = W (b b^T)`` with W the 0/1 membership, and
   ``C = M2 - S1 S1^T / n``. The twin counts the row at each halving; the
   kernel selects the k-th value once, exactly, and halves on scalars,
   which gives the same threshold bit for bit.

Each kernel has a plain twin with the same math (``*_ref``): the CPU path
and the golden of the on-card check. The twins round every value that
decides a membership (scores, d², the bisection) in the kernels' order,
one IEEE rounding per operation in lane order (``fused_step.lane_dot`` /
``dot3``), so kernel and twin pick the same neighbours; the W-sums differ
only in summation order. Like the JAX package, the W-sums keep ``dot3``'s
split: with W 0/1 it sums the bf16 hi and lo parts of each term apart and
adds the two sums at the end, which keeps ~16 significant bits per term
(the reference's rounding, not full float32).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icp_tpu_torch.kernels import native

# fused_step's score helpers are imported inside the twins: fused_step
# imports ops.distance, whose package re-exports ops.normals, which imports
# this module's wrappers, so a module-level import here would meet a
# half-initialized fused_step.

BISECT_ITERS = 18  # halvings of the k-th distance value (the reference's)
# The 6 unique entries (i, j) of a symmetric 3x3, in the order
# c00, c01, c02, c11, c12, c22.
_UI = [0, 0, 0, 1, 1, 2]
_UJ = [0, 1, 2, 1, 2, 2]


def bin_counts(ids: torch.Tensor, n_r: int) -> torch.Tensor:
    """(n_r,) int32 exact counts of ``ids`` (a scatter-add: no host read,
    unlike ``torch.bincount`` on CUDA)."""
    ids = ids.long()
    return torch.zeros((n_r,), dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids)).to(torch.int32)


# ---------------------------------------------------------------------------
# K9: top-2 nearest representatives + per-choice counts
# ---------------------------------------------------------------------------


def rep_top2_counts_ref(p3: torch.Tensor, reps: torch.Tensor,
                        chunk: int = 16384):
    """Plain twin of :func:`rep_top2_counts`, in chunks of rows (the whole
    (m, n_r) score is 2 GB at 262144 x 2048)."""
    from icp_tpu_torch.kernels.fused_step import dot3, lane_dot

    n_r = reps.shape[0]
    srow = lane_dot(reps, reps)
    firsts, seconds = [], []
    for s in range(0, p3.shape[0], chunk):
        scores = srow - 2.0 * dot3(p3[s:s + chunk, None, :], reps[None, :, :])
        sel1 = torch.argmin(scores, dim=1)
        # Mask the winner's column only (by id), then the first minimum.
        scores.scatter_(1, sel1[:, None], float("inf"))
        firsts.append(sel1)
        seconds.append(torch.argmin(scores, dim=1))
    i1 = torch.cat(firsts).to(torch.int32)
    i2 = torch.cat(seconds).to(torch.int32)
    return i1, i2, torch.stack([bin_counts(i1, n_r), bin_counts(i2, n_r)])


def rep_top2_counts(p3: torch.Tensor, reps: torch.Tensor):
    """First and second nearest representative of every point, with the
    per-choice bin counts; K9, replacing
    ``icp_tpu.kernels.knn_moments.rep_top2_counts_pallas``.

    Args:
      p3: (m, 3) float32 RAW points (zero rows for invalid points).
      reps: (n_r, 3) float32 representatives.
    Returns:
      (i1 (m,) int32, i2 (m,) int32, counts (2, n_r) int32) with
      ``counts[j][b] == sum(i_{j+1} == b)`` exactly.
    """
    if p3.device.type == "cpu":
        return rep_top2_counts_ref(p3, reps)
    native.require_cuda(p3, "p3")
    dev = p3.device
    m, n_r = p3.shape[0], reps.shape[0]
    native.require(p3, "p3", (m, 3), torch.float32, dev)
    native.require(reps, "reps", (n_r, 3), torch.float32, dev)
    if n_r == 0:
        raise ValueError("rep_top2_counts: no representatives")
    i1 = torch.empty((m,), dtype=torch.int32, device=dev)
    i2 = torch.empty((m,), dtype=torch.int32, device=dev)
    counts = torch.zeros((2, n_r), dtype=torch.int32, device=dev)
    lib = native.load_library()
    native.check(lib.icp_rep_top2_counts(
        p3.data_ptr(), reps.data_ptr(), m, n_r, i1.data_ptr(), i2.data_ptr(),
        counts.data_ptr(), native.stream_ptr(dev)), "icp_rep_top2_counts")
    rep_top2_counts.launches += 1
    return i1, i2, counts


rep_top2_counts.launches = 0


# ---------------------------------------------------------------------------
# K8: per-query kNN covariance components
# ---------------------------------------------------------------------------


def _knn_math(qp, bins, reps, bvalid, k: int):
    """The reference's ``_knn_math`` on a chunk of bins: ((c00, c01, c02,
    c11, c12, c22) each (BB, cq), cnt (BB, cq))."""
    from icp_tpu_torch.kernels.fused_step import _bf16_round, dot3, lane_dot

    qp = qp - reps[:, None, :]
    bins = bins - reps[:, None, :]
    sq_b = lane_dot(bins, bins)
    sq_b = torch.where(bvalid & torch.isfinite(sq_b), sq_b, float("inf"))
    # NaN-encoded invalid candidates are out of every neighbourhood through
    # sq_b = +inf; zero them so they cannot poison the W-sums.
    bins = torch.where(torch.isfinite(bins), bins, 0.0)
    sq_q = lane_dot(qp, qp)
    cross = dot3(qp[:, :, None, :], bins[:, None, :, :])
    d2 = sq_q[..., None] - 2.0 * cross + sq_b[:, None, :]
    finite = torch.isfinite(d2)
    k_eff = torch.clamp(finite.sum(-1, dtype=qp.dtype), max=float(k))

    # Bisection on the k-th smallest value: count(<= hi) >= k_eff (hi starts
    # above every finite d2), count(<= lo) < k_eff.
    hi = torch.amax(torch.where(finite, d2, 0.0), dim=-1) + 1.0
    lo = torch.full_like(hi, -1.0)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take_hi = (d2 <= mid[..., None]).sum(-1, dtype=qp.dtype) >= k_eff
        hi = torch.where(take_hi, mid, hi)
        lo = torch.where(take_hi, lo, mid)

    W = ((d2 <= hi[..., None]) & finite).to(qp.dtype)
    cnt = torch.clamp(W.sum(-1), min=1.0)
    # dot3(W, x) with W 0/1: W @ x_hi + W @ x_lo (fp32 matmuls; only the
    # summation order differs from the kernel).
    b6 = bins[..., _UI] * bins[..., _UJ]

    def wsum(x):
        x_hi = _bf16_round(x)
        return torch.matmul(W, x_hi) + torch.matmul(W, _bf16_round(x - x_hi))

    S1 = wsum(bins)
    M2 = wsum(b6)
    C = M2 - S1[..., _UI] * S1[..., _UJ] / cnt[..., None]
    return tuple(C[..., u] for u in range(6)), cnt


def bin_knn_moments_ref(qp: torch.Tensor, bins: torch.Tensor,
                        reps: torch.Tensor, bvalid: torch.Tensor, *, k: int,
                        chunk: int = 128):
    """Plain twin of :func:`bin_knn_moments`, in chunks of ``chunk`` bins
    (the (chunk, cq, cb) distance tensor bounds its memory)."""
    outs = [_knn_math(qp[s:s + chunk], bins[s:s + chunk], reps[s:s + chunk],
                      bvalid[s:s + chunk], k)
            for s in range(0, qp.shape[0], chunk)]
    comps = tuple(torch.cat([o[0][u] for o in outs]) for u in range(6))
    return comps, torch.cat([o[1] for o in outs])


@functools.cache
def _workspace_floats(device_index: int, n_r: int, cq: int, cb: int) -> int:
    """Floats of K8's global workspace at these capacities on this device
    (0: its arrays fit in shared memory)."""
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        native.check(native.load_library().icp_bin_knn_moments_workspace(
            n_r, cq, cb, ctypes.byref(floats)), "icp_bin_knn_moments_workspace")
    return floats.value


def bin_knn_moments(qp: torch.Tensor, bins: torch.Tensor, reps: torch.Tensor,
                    bvalid: torch.Tensor, *, k: int, chunk: int = 128):
    """Per-query kNN covariance components; K8, replacing
    ``icp_tpu.kernels.knn_moments.bin_knn_moments_pallas``.

    Args:
      qp: (n_r, cq, 3) float32 RAW grouped queries, NaN for invalid points;
        on CUDA its rows may be lanes 0:3 of a wider grouped table.
      bins: (n_r, cb, 3) float32 RAW candidates, NaN for invalid points.
      reps: (n_r, 3) float32 bin representatives (the centring).
      bvalid: (n_r, cb) bool slot occupancy.
      k: neighbourhood size.
      chunk: bins per step of the CPU twin.
    Returns:
      ((c00, c01, c02, c11, c12, c22) each (n_r, cq), cnt (n_r, cq)) float32,
      cnt the neighbourhood size (at least 1).
    """
    if qp.device.type == "cpu":
        return bin_knn_moments_ref(qp, bins, reps, bvalid, k=k, chunk=chunk)
    native.require_cuda(qp, "qp")
    dev = qp.device
    n_r, cq, _ = qp.shape
    cb = bins.shape[1]
    f32 = torch.float32
    ld_q = native.require_rows(qp, "qp", (n_r, cq, 3), f32, dev)
    native.require(bins, "bins", (n_r, cb, 3), f32, dev)
    native.require(reps, "reps", (n_r, 3), f32, dev)
    native.require(bvalid, "bvalid", (n_r, cb), torch.bool, dev)
    out = torch.empty((7, n_r, cq), dtype=f32, device=dev)
    lib = native.load_library()
    # Where a block's candidates, d2 rows and selection buffers do not fit
    # in shared memory (large cb), or the query tiles pass the grid's second
    # dimension (cq past ~131000), the kernel keeps them in this workspace.
    floats = _workspace_floats(dev.index, n_r, cq, cb)
    ws = torch.empty((floats,), dtype=f32, device=dev) if floats else None
    native.check(lib.icp_bin_knn_moments(
        qp.data_ptr(), ld_q, bins.data_ptr(), reps.data_ptr(), bvalid.data_ptr(),
        n_r, cq, cb, k, out.data_ptr(), None if ws is None else ws.data_ptr(),
        native.stream_ptr(dev)), "icp_bin_knn_moments")
    bin_knn_moments.launches += 1
    return tuple(out[u] for u in range(6)), out[6]


bin_knn_moments.launches = 0
