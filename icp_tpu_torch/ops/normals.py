"""Surface normals (port of ``icp_tpu.ops.normals``).

Two kinds of estimator feed the PLANE and GICP objectives:

* :func:`grid_normals`: organized landmark grids (the 16384 landmarks are a
  128 x 128 sample of the organized image, ``ops.sampling.get_landmarks``):
  central differences of the grid neighbours, no neighbourhood search.
* kNN PCA for UNORGANIZED clouds (LiDAR sweeps, merged maps), the
  smallest-scatter direction of each point's k nearest neighbours:
  :func:`knn_normals`, exact brute force (fp32 distance strips, a stable
  k-smallest selection, a batched ``eigh``), and :func:`knn_normals_rbc`,
  the Random-Ball-Cover estimator for large clouds (K9
  ``rep_top2_counts`` assigns the points to two bins each, K2 builds the
  bin tables, K8 ``bin_knn_moments`` gives each query's kNN covariance, and
  a closed-form 3x3 eigenvector the normal).

:func:`normals_for` dispatches on ``ICPConfig.normal_mode``. Every
estimator runs once per registration, on the input's device, and reads
nothing back to the host on the RBC path.
"""

from __future__ import annotations

import math

import torch

from icp_tpu_torch.kernels.knn_moments import (bin_counts, bin_knn_moments,
                                               rep_top2_counts)
from icp_tpu_torch.ops.sampling import LM_GRID
from icp_tpu_torch.runtime.timing import span

# rbc.grouping is imported inside _knn_rbc_tail, as in icp_tpu.ops.normals:
# the rbc package re-exports rbc.construct, which imports the kernels, and
# kernels.fused_step imports ops.distance, whose package re-exports this
# module.

KNN_BRUTE_MAX = 16384  # "knn" above this many points takes the RBC estimator


def grid_normals(landmarks8: torch.Tensor, grid: int = LM_GRID) -> torch.Tensor:
    """Per-landmark unit normals from the organized grid.

    Args:
      landmarks8: (grid*grid, 8) landmarks in row-major grid order.
    Returns:
      (grid*grid, 3) unit normals oriented toward the camera (n_z <= 0, the
      clouds look down +z); zero where the point or one of its 4-neighbours
      has zero geometry (the grid edge counts its own border as neighbour).
    """
    pts = landmarks8.reshape(grid, grid, 8)[..., :3]
    # Central differences inside, one-sided at the edges (jnp.gradient).
    (du,) = torch.gradient(pts, dim=1, edge_order=1)
    (dv,) = torch.gradient(pts, dim=0, edge_order=1)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm > 1e-12, norm, torch.ones_like(norm))
    # Face the camera: the surface faces the origin.
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)

    # Edge-padded neighbour validity (not a wraparound roll, which would let
    # one image border's holes invalidate the opposite border).
    valid = torch.sum(torch.abs(pts), dim=-1) > 0
    vp = torch.cat([valid[:1], valid, valid[-1:]], dim=0)
    vp = torch.cat([vp[:, :1], vp, vp[:, -1:]], dim=1)
    v = (valid & vp[:-2, 1:-1] & vp[2:, 1:-1] & vp[1:-1, :-2] & vp[1:-1, 2:])
    n = torch.where(v[..., None], n, torch.zeros_like(n))
    return n.reshape(grid * grid, 3)


def knn_normals(points8: torch.Tensor, k: int = 16, block: int = 2048) -> torch.Tensor:
    """PCA normals from the exact geometric k nearest neighbours.

    Per point: its k nearest valid points (itself included), the
    smallest-eigenvalue eigenvector of their covariance, oriented toward the
    sensor origin (n . p < 0). Queries go through in (block, m) fp32
    distance strips padded to the block; the k smallest of each row come
    from a stable sort, so on equal distances the lower index wins, as with
    ``lax.top_k``.

    Args:
      points8: (m, 8) cloud; invalid (zero-geometry) points get zero
        normals and are excluded from every neighbourhood.
      k: neighbourhood size.
      block: queries per strip.
    """
    p = points8[:, :3]
    m = p.shape[0]
    valid = torch.sum(torch.abs(p), dim=-1) > 0
    sq = torch.sum(p * p, dim=-1)
    pad = (-m) % block
    p_q = torch.cat([p, p.new_zeros((pad, 3))]) if pad else p
    idx = []
    for s in range(0, m + pad, block):
        q = p_q[s:s + block]
        d = torch.sum(q * q, dim=-1)[:, None] - 2.0 * (q @ p.T) + sq[None, :]
        d = torch.where(valid[None, :], d, float("inf"))
        idx.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    nb = p[torch.cat(idx)[:m]]  # (m, k, 3)
    dev = nb - torch.mean(nb, dim=1, keepdim=True)
    _, vecs = torch.linalg.eigh(torch.einsum("mki,mkj->mij", dev, dev))
    n = vecs[..., 0]  # ascending eigenvalues: the smallest scatter
    n = n * torch.where(torch.sum(n * p, dim=-1, keepdim=True) > 0, -1.0, 1.0)
    return torch.where(valid[:, None], n, 0.0)


def _morton_order(p: torch.Tensor) -> torch.Tensor:
    """(m,) int32 permutation sorting points by 3-D Morton (z-order) code:
    10 bits per axis over the bounding box (truncated toward zero), int32
    bit spreading and one stable sort, as the JAX package computes it."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0,
                    0.0, 1023.0).to(torch.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(key, stable=True).to(torch.int32)


def _smallest_eigvec3_components(a00, a01, a02, a11, a12, a22):
    """Closed-form smallest-eigenvalue eigenvector of symmetric 3x3 batches,
    component-wise: the trigonometric eigenvalue form, then the cross
    product of the two rows of C - lam I with the largest norm.
    Ill-conditioned (isotropic or degenerate) scatter falls back to +z.

    Args:
      a00..a22: (...,) unique components of symmetric PSD matrices.
    Returns:
      (nx, ny, nz) unit eigenvector components of the smallest eigenvalue.
    """
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    # det(B / p) / 2 with B = C - q I.
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    # Eigenvalues q + 2p cos(phi + {0, 2pi/3, 4pi/3}); the smallest is the
    # 2pi/3 branch.
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01 = (a01 * a12 - a02 * m11,
           a02 * a01 - m00 * a12,
           m00 * m11 - a01 * a01)
    c02 = (a01 * m22 - a02 * a12,
           a02 * a02 - m00 * m22,
           m00 * a12 - a01 * a02)
    c12 = (m11 * m22 - a12 * a12,
           a12 * a02 - a01 * m22,
           a01 * a12 - m11 * a02)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    pick01 = (n01 >= n02) & (n01 >= n12)
    pick02 = n02 >= n12
    best = tuple(torch.where(pick01, x01, torch.where(pick02, x02, x12))
                 for x01, x02, x12 in zip(c01, c02, c12))
    norm2 = best[0] * best[0] + best[1] * best[1] + best[2] * best[2]
    ok = norm2 > 1e-20
    inv = 1.0 / torch.sqrt(torch.where(ok, norm2, 1.0))
    return (torch.where(ok, best[0] * inv, 0.0),
            torch.where(ok, best[1] * inv, 0.0),
            torch.where(ok, best[2] * inv, 1.0))


def _smallest_eigvec3(C: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric PSD -> (..., 3) smallest-eigenvalue unit
    eigenvectors (stacked form of :func:`_smallest_eigvec3_components`)."""
    return torch.stack(_smallest_eigvec3_components(
        C[..., 0, 0], C[..., 0, 1], C[..., 0, 2],
        C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]), dim=-1)


def _rep_choices_strip(p: torch.Tensor, reps: torch.Tensor, multi_assign: int,
                       block: int = 8192):
    """The ``multi_assign`` nearest representatives of every point by
    successive masked argmins over fp32 (block, n_r) distance strips; each
    pass masks ALL occurrences of the minimum. Returns (rep_ids (m, a)
    int32, counts (a, n_r) int32 exact per choice)."""
    n_r = reps.shape[0]
    sq_r = torch.sum(reps * reps, dim=-1)
    ids = []
    for s in range(0, p.shape[0], block):
        q = p[s:s + block]
        d = torch.sum(q * q, dim=-1)[:, None] - 2.0 * (q @ reps.T) + sq_r[None, :]
        cols = []
        for _ in range(multi_assign):
            cols.append(torch.argmin(d, dim=1))
            d = torch.where(d <= torch.amin(d, dim=1, keepdim=True), float("inf"), d)
        ids.append(torch.stack(cols, dim=-1))
    rep_ids = torch.cat(ids).to(torch.int32)
    counts = torch.stack([bin_counts(rep_ids[:, j], n_r) for j in range(multi_assign)])
    return rep_ids, counts


def knn_rbc_capacities(m: int, n_r: int = 0) -> tuple[int, int]:
    """(representatives, query capacity) of :func:`knn_normals_rbc` on m
    points: n_r 0 is its automatic choice (about m/128 mean occupancy, a
    power of two, at least 64), never more than m; the capacity is 1.5x the
    mean occupancy per choice."""
    if n_r == 0:
        n_r = max(64, 1 << max(0, (m // 128 - 1).bit_length()))
    n_r = min(n_r, m)
    return n_r, max(((3 * (m // n_r) // 2 + 7) // 8) * 8, 16)


def knn_normals_rbc(points8: torch.Tensor, k: int = 16, n_r: int = 0,
                    multi_assign: int = 2, chunk: int = 128) -> torch.Tensor:
    """RBC-accelerated PCA normals for large unorganized clouds.

    1. Representatives: a strided walk of the Morton order (spatially
       stratified, about equal-mass cells).
    2. Each point's ``multi_assign`` nearest representatives: K9
       (:func:`rep_top2_counts`) for 2, the fp32 masked-argmin strips
       otherwise, with exact per-choice counts.
    3.-5. :func:`_knn_rbc_tail`: groupings, per-bin kNN covariances (K8),
       closed-form eigenvectors, orientation and scatter.

    The neighbours are exact within the union of the query's
    ``multi_assign`` nearest balls. Queries that overflow their bin get zero
    normals (no plane constraint).

    Args:
      points8: (m, 8) cloud; zero-geometry points get zero normals and are
        excluded from every neighbourhood.
      k: neighbourhood size.
      n_r: representative count (0 = auto: about m/128 mean occupancy, a
        power of two, at least 64).
      multi_assign: database-side bin multiplicity (2 covers ball
        boundaries; 1 is single-ball RBC). Kept for parity with
        ``icp_tpu``'s signature: nothing in this package passes another
        value than 2, so only K9's front half runs on the registration
        path and the strip half is reached only by a direct call.
      chunk: bins per step of K8's CPU twin.
    """
    p = points8[:, :3].contiguous()
    m = p.shape[0]
    n_r, _ = knn_rbc_capacities(m, n_r)
    valid = torch.sum(torch.abs(p), dim=-1) > 0
    stride = m // n_r
    reps = p[_morton_order(p)[stride // 2::stride][:n_r].long()]
    if multi_assign == 2:
        i1, i2, counts = rep_top2_counts(p, reps)
        rep_ids = torch.stack([i1, i2], dim=-1)
    else:
        rep_ids, counts = _rep_choices_strip(p, reps, multi_assign)
    return _knn_rbc_tail(p, valid, rep_ids, counts, reps, n_r, k, multi_assign, chunk)


def _knn_rbc_tail(p: torch.Tensor, valid: torch.Tensor, rep_ids: torch.Tensor,
                  counts: torch.Tensor, reps: torch.Tensor, n_r: int, k: int,
                  multi_assign: int, chunk: int) -> torch.Tensor:
    """Grouping, per-bin covariances, eigenvectors and the scatter back
    (shared by both front halves of :func:`knn_normals_rbc`).

    The first-choice grouping is both the query set and the first part of
    every bin's candidates; each further choice adds a grouping of its own.
    Capacity is 1.5x the mean occupancy per choice. Invalid points ride as
    NaN (K8 drops them from every neighbourhood), the original ids as a
    float payload (exact below 2^24 points).
    """
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin

    m = p.shape[0]
    _, cq = knn_rbc_capacities(m, n_r)
    p_nan = torch.where(valid[:, None], p, float("nan"))
    ids = torch.arange(m, dtype=p.dtype, device=p.device)[:, None]
    g1 = group_rows_by_bin(rep_ids[:, 0].contiguous(), n_r, cq, (p_nan, ids),
                           counts=counts[0])
    qp = g1.grouped[0]  # (n_r, cq, 3) rows of the 4-wide table
    qid = g1.grouped[1][..., 0].to(torch.int64)
    qvalid = g1.valid & torch.isfinite(qp[..., 0])
    parts, vparts = [qp], [g1.valid]
    for j in range(1, multi_assign):
        gj = group_rows_by_bin(rep_ids[:, j].contiguous(), n_r, cq, (p_nan,),
                               counts=counts[j])
        parts.append(gj.grouped[0])
        vparts.append(gj.valid)
    bins = torch.cat(parts, dim=1)  # (n_r, multi_assign * cq, 3)
    slot_valid = torch.cat(vparts, dim=1)

    comps, _ = bin_knn_moments(qp, bins, reps, slot_valid, k=k, chunk=chunk)
    nx, ny, nz = _smallest_eigvec3_components(*comps)
    # Orient toward the sensor origin (n . p < 0), on the raw coordinates.
    ip = nx * qp[..., 0] + ny * qp[..., 1] + nz * qp[..., 2]
    sgn = torch.where(ip > 0, -1.0, 1.0)

    # Scatter back to the original order. Invalid and overflowed slots go
    # to a spare row m that is cut off: they never land on a valid row, and
    # points without a slot keep zero normals.
    tgt = torch.where(qvalid, qid, m).reshape(-1)
    vals = torch.stack([nx * sgn, ny * sgn, nz * sgn], dim=-1).reshape(-1, 3)
    out = p.new_zeros((m + 1, 3)).index_put_((tgt,), vals)[:m]
    return torch.where(valid[:, None], out, 0.0)


def normals_for(points8: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Normals by ``ICPConfig.normal_mode``.

    "knn_rbc": the RBC estimator at any size. "knn": PCA of the exact k
    nearest neighbours up to 16384 points, the RBC estimator above.
    "grid": organized row-major square grid (error if the count is not a
    square). "auto": square counts of at least 8 x 8 are taken as organized
    and get grid normals, other counts zeros (no plane constraint); it
    cannot tell an organized cloud from a random one of square size, so
    unorganized clouds need "knn".
    """
    m = points8.shape[0]
    with span("icp.normals"):
        if mode == "knn_rbc" or (mode == "knn" and m > KNN_BRUTE_MAX):
            return knn_normals_rbc(points8)
        if mode == "knn":
            return knn_normals(points8)
        side = int(m ** 0.5)
        if side * side == m and side >= 8:
            return grid_normals(points8, side)
        if mode == "grid":
            raise ValueError(f"normal_mode='grid' needs a square point count, got m={m}")
        return points8.new_zeros((m, 3))
