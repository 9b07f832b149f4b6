"""Exact brute-force nearest neighbour (port of ``icp_tpu.kernels.brute_nn``).

:func:`brute_nn` (K6, ``csrc/brute_nn.cu``) returns, for each weighted
query, the database index and value of

    score[i] = min_j  sq_db[j] - 2 qw[i] . db[j]

(first minimum on ties) without forming the (m, n) score matrix; the caller
adds the per-query constant |q|^2_w to the winner only
(``ops.distance.nearest_neighbor_brute``). The products run in full float32,
one rounding per multiply and per add in lane order, in the kernel's
re-score and in its plain twin :func:`brute_nn_ref` alike, so the two pick
the same index. The kernel scores every pair first on the tensor cores
(3xTF32) and re-scores exactly only the pairs that a proven error margin
leaves in the running; it computes the margin on the device from KAPPA and
MARGIN_FLOOR below.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import native

# Queries per block of the twin: a (chunk, n) score block instead of the
# (m, n) matrix (1 GB at 16384 x 16384).
REF_CHUNK = 1024
# eps_i = KAPPA 2^-20 (S + 2 A_i) + MARGIN_FLOOR, with S = max_j |sq_db_j|
# and A_i = sum_k |qw_ik| max_j |db_jk|, bounds the distance between the
# kernel's 3xTF32 score and the twin's; csrc/brute_nn.cu derives
# KAPPA >= 5.27 from the rounding of the split, the tensor cores'
# accumulation (as truncation), the twin's lane-order sum and the
# comparisons, and the floor covers products below float32's normal range.
KAPPA = 6.0
MARGIN_FLOOR = 2.0 ** -100


def brute_nn_ref(qw: torch.Tensor, db: torch.Tensor, sq_db: torch.Tensor, *,
                 chunk: int = REF_CHUNK):
    """Plain twin of :func:`brute_nn`: (idx (m,) int32, score (m,))."""
    # Imported here: fused_step imports ops.distance, which imports this module.
    from icp_tpu_torch.kernels.fused_step import lane_dot

    m = qw.shape[0]
    idx = torch.empty((m,), dtype=torch.int32, device=qw.device)
    score = torch.empty((m,), dtype=qw.dtype, device=qw.device)
    for lo in range(0, m, chunk):
        s = sq_db[None, :] - 2.0 * lane_dot(qw[lo:lo + chunk, None, :], db[None, :, :])
        best = torch.argmin(s, dim=1)
        idx[lo:lo + chunk] = best.to(torch.int32)
        score[lo:lo + chunk] = torch.gather(s, 1, best[:, None])[:, 0]
    return idx, score


def brute_nn(qw: torch.Tensor, db: torch.Tensor, sq_db: torch.Tensor, *,
             count_rescored: bool = False):
    """Exact NN by a tiled sweep of the database; K6, replacing
    ``icp_tpu.kernels.brute_nn.brute_nn_pallas``.

    Args:
      qw: (m, 8) float32 metric-weighted queries (q * w8).
      db: (n, 8) float32 database (the metric rides in qw and sq_db).
      sq_db: (n,) float32 weighted squared norms sum(w8 * db^2).
      count_rescored: also return the pairs the kernel re-scored exactly,
        per query (CUDA only).
    Returns:
      (idx (m,) int32, score (m,) float32 = sq_db[idx] - 2 qw . db[idx]),
      and with ``count_rescored`` a third (m,) int32 tensor.
    """
    if qw.device.type == "cpu":
        if count_rescored:
            raise ValueError("brute_nn: count_rescored needs CUDA tensors")
        return brute_nn_ref(qw, db, sq_db)
    native.require_cuda(qw, "qw")
    dev = qw.device
    m = qw.shape[0]
    n = db.shape[0]
    f32 = torch.float32
    native.require(qw, "qw", (m, 8), f32, dev)
    native.require(db, "db", (n, 8), f32, dev)
    native.require(sq_db, "sq_db", (n,), f32, dev)
    for t, name in ((qw, "qw"), (db, "db"), (sq_db, "sq_db")):
        native.require_aligned(t, name)
    if n == 0:
        raise ValueError("brute_nn: empty database")
    ms = torch.empty((9,), dtype=f32, device=dev)  # the margin's maxima
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    score = torch.empty((m,), dtype=f32, device=dev)
    rescored = torch.empty((m,), dtype=torch.int32, device=dev) if count_rescored else None
    lib = native.load_library()
    native.check(lib.icp_brute_nn(
        qw.data_ptr(), db.data_ptr(), sq_db.data_ptr(), ms.data_ptr(),
        KAPPA * 2.0 ** -20, MARGIN_FLOOR, m, n, idx.data_ptr(), score.data_ptr(),
        None if rescored is None else rescored.data_ptr(),
        native.stream_ptr(dev)), "icp_brute_nn")
    brute_nn.launches += 1
    return (idx, score, rescored) if count_rescored else (idx, score)


brute_nn.launches = 0
