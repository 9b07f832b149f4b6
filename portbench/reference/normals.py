"""Plain kNN PCA normals of an unorganized cloud: each point's normal is the
smallest-scatter eigenvector of the covariance of its k nearest points
(itself included), turned to face the origin (n . p <= 0).

Up to :data:`EXACT_MAX` points the neighbours are the exact k nearest.
Above, they are searched over two nearest balls. Representatives: every
(m / n_r)-th point of the 3-D Morton order (10 bits an axis over the bounding
box), from the middle of the first stride, with n_r the power of two
nearest above m / 128 (at least 64). Every point
belongs to the balls of its two nearest representatives; each ball holds
its first-choice members and, apart, its second-choice members, each in
index order up to 1.5x the mean occupancy. A point that is among the first
``cq`` first-choice members of its ball gets the normal of its k nearest
points among the ball's members of either kind; the other points get zero
normals (no plane constraint).
"""

from __future__ import annotations

import torch

from portbench.reference.icp import bins_in_index_order

BALL_CELLS = 1 << 25  # distance cells per block of balls
EXACT_MAX = 16384  # the largest cloud whose neighbours are searched exactly


def capacities(m: int) -> tuple[int, int]:
    """(n_r, cq) of the estimator on m points."""
    n_r = min(max(64, 1 << max(0, (m // 128 - 1).bit_length())), m)
    return n_r, max(((3 * (m // n_r) // 2 + 7) // 8) * 8, 16)


def morton_order(p: torch.Tensor) -> torch.Tensor:
    """Stable order of the points by their 30-bit Morton code over the
    bounding box (coordinates scaled to 0..1023 and truncated)."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    key = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for bit in range(10):
        for axis in range(3):
            key |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(key, stable=True)


def two_nearest(p: torch.Tensor, reps: torch.Tensor, chunk: int = 32768):
    """(first, second) nearest representative of each point, (m,) each,
    on coordinates centred on the representatives' mean."""
    ctr = reps.mean(0)
    rc = reps - ctr
    sq_r = (rc * rc).sum(1)
    first, second = [], []
    for s in range(0, p.shape[0], chunk):
        d2 = sq_r - 2.0 * ((p[s:s + chunk] - ctr) @ rc.T)
        i1 = torch.argmin(d2, dim=1)
        d2.scatter_(1, i1[:, None], float("inf"))
        first.append(i1)
        second.append(torch.argmin(d2, dim=1))
    return torch.cat(first), torch.cat(second)


def pca_normals(nb: torch.Tensor, take: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(n, 3) float64 normals from neighbours nb (n, k, 3) (those with
    ``take`` (n, k)) of the points pts (n, 3)."""
    x = nb.double()
    wt = take.double()[..., None]
    cnt = wt.sum(1, keepdim=True).clamp(min=1.0)
    dev = (x - (x * wt).sum(1, keepdim=True) / cnt) * wt
    # The batched 3x3 eigensolve runs on the host: cuSOLVER's batched
    # eigensolver refuses batches this large.
    cov = torch.einsum("nki,nkj->nij", dev, dev)
    n = torch.linalg.eigh(cov.cpu())[1][..., 0].to(cov.device)
    return torch.where((n * pts.double()).sum(1, keepdim=True) > 0, -n, n)


def exact_normals(p: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Normals from the exact k nearest valid points, in blocks of rows."""
    sq = (p * p).sum(1)
    out = []
    for s in range(0, p.shape[0], 2048):
        q = p[s:s + 2048]
        d2 = (q * q).sum(1)[:, None] + sq[None, :] - 2.0 * (q @ p.T)
        d2 = torch.where(valid[None, :], d2, float("inf"))
        dk, nb = torch.topk(d2, min(k, p.shape[0]), dim=1, largest=False)
        out.append(pca_normals(p[nb], torch.isfinite(dk), q))
    return torch.where(valid[:, None], torch.cat(out), 0.0)


def knn_normals(points8: torch.Tensor, k: int = 16) -> torch.Tensor:
    """(m, 3) normals of the (m, 8) cloud's geometry."""
    p = points8[:, :3]
    m = p.shape[0]
    valid = p.abs().sum(1) > 0
    if m <= EXACT_MAX:
        return exact_normals(p, valid, k).to(torch.float32)
    n_r, cq = capacities(m)
    stride = m // n_r
    reps = p[morton_order(p)[stride // 2::stride][:n_r]]
    i1, i2 = two_nearest(p, reps)
    queries = bins_in_index_order(i1, n_r, cq)  # (n_r, cq)
    members = torch.cat([queries, bins_in_index_order(i2, n_r, cq)], dim=1)
    member_ok = (members >= 0) & valid[members.clamp(min=0)]
    query_ok = (queries >= 0) & valid[queries.clamp(min=0)]
    normals = torch.zeros((m, 3), dtype=torch.float64, device=p.device)
    block = max(1, BALL_CELLS // (cq * members.shape[1]))
    for s in range(0, n_r, block):
        qi, mi = queries[s:s + block], members[s:s + block]
        qp = p[qi.clamp(min=0)] - reps[s:s + block, None, :]
        mp = p[mi.clamp(min=0)] - reps[s:s + block, None, :]
        d2 = ((qp * qp).sum(-1)[:, :, None] + (mp * mp).sum(-1)[:, None, :]
              - 2.0 * torch.bmm(qp, mp.transpose(1, 2)))
        d2 = torch.where(member_ok[s:s + block, None, :], d2, float("inf"))
        kk = min(k, d2.shape[2])
        dk, nb = torch.topk(d2, kk, dim=2, largest=False)
        ok = query_ok[s:s + block]
        rows = torch.arange(nb.shape[0], device=p.device)[:, None, None]
        x = mp[rows, nb]  # (B, cq, k, 3) neighbours, ball-centred
        normals[qi[ok]] = pca_normals(x[ok], torch.isfinite(dk)[ok], p[qi[ok]])
    return normals.to(torch.float32)
