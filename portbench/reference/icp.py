"""Plain ICP with Random Ball Cover correspondences.

Per registration: representatives at index strides of the fixed set, every
fixed point assigned to its nearest representative, and each
representative's bin holding its points in index order up to the bin
capacity. Per iteration: the moving set under the accumulated similarity,
each moving point assigned to its nearest representative (the first
``query_capacity`` of a bin in index order are searched, the rest sit the
iteration out), its nearest fixed point in that bin, the weight
100 / (100 + d^2) of the blended squared distance d^2, then either Horn's
closed form (POINT: weighted centroids, cross-covariance, the most positive
eigenvector of Horn's N, scale sqrt(sum w|f'|^2 / sum w|m'|^2)) or one damped
point-to-plane Gauss-Newton step (PLANE) for the increment, which is composed
into the accumulated transform. The loop stops after ``max_iterations`` or
once the increment's angle and translation are both under their thresholds.

Distances are |a|^2_w + |b|^2_w - 2 a.b_w through matrix products on
coordinates centred on the representatives; sums of products are matrix
products too. The 4x4 eigenproblem and the 6x6 solve run in float64.
"""

from __future__ import annotations

import contextlib
import math

import torch

ROW_CHUNK = 32768  # rows per block of a point-to-representative product
CELLS = 1 << 25  # distance cells per block of the in-bin search
CHARACTERISTIC_LENGTH_MM = 1.0e3  # the rotation columns' unit in the 6x6 step


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matrix products in full float32 (TF32 off), or in TF32 for the
    control; the previous settings are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def metric_weights(alpha: float, device) -> torch.Tensor:
    """[1, 1, 1, 0, alpha, alpha, alpha, 0]: geometry plus alpha x colour."""
    return torch.tensor([1, 1, 1, 0, alpha, alpha, alpha, 0],
                        dtype=torch.float32, device=device)


def nearest_rep(points: torch.Tensor, reps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n,) int64 nearest representative (first on ties) of each point under
    the weighted metric, in blocks of rows."""
    ctr = reps.mean(dim=0)
    rc = reps - ctr
    rw = rc * w
    sq_r = (rw * rc).sum(dim=1)
    out = []
    for s in range(0, points.shape[0], ROW_CHUNK):
        pc = points[s:s + ROW_CHUNK] - ctr
        d2 = (pc * w * pc).sum(dim=1, keepdim=True) + sq_r - 2.0 * (pc @ rw.T)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def representative_indices(n: int, n_r: int) -> torch.Tensor:
    """Indices of the representatives: on a square count, a side x side grid
    strided by (side / n_ry, side / n_rx) from the middle of the first
    stride, with n_r = n_ry x n_rx split as evenly as powers of two allow;
    otherwise every (n / n_r)-th index from the middle of the first stride."""
    side = math.isqrt(n)
    p = n_r.bit_length() - 1
    if side * side == n and side >= 4 and (1 << p) == n_r:
        n_ry, n_rx = 1 << (p // 2), 1 << (p - p // 2)
        if side % n_rx == 0 and side % n_ry == 0:
            sy, sx = side // n_ry, side // n_rx
            ys = torch.arange(n_ry) * sy + max(sy // 2 - 1, 0)
            xs = torch.arange(n_rx) * sx + max(sx // 2 - 1, 0)
            return (ys[:, None] * side + xs[None, :]).reshape(-1)
    step = n // n_r
    return torch.arange(n_r) * step + max(step // 2 - 1, 0)


def bins_in_index_order(ids: torch.Tensor, n_bins: int, capacity: int) -> torch.Tensor:
    """(n_bins, capacity) int64 member table: bin b holds the indices i with
    ids[i] == b in increasing order, the first ``capacity`` of them; -1
    pads."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    counts = torch.bincount(ids, minlength=n_bins)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=ids.device) - starts[sid]
    keep = rank < capacity
    table = torch.full((n_bins, capacity), -1, dtype=torch.long, device=ids.device)
    table[sid[keep], rank[keep]] = order[keep]
    return table


def capacities(m: int, n_r: int) -> tuple[int, int]:
    """(bin capacity, query capacity): 2x and 1.5x the mean occupancy
    max(m // n_r, 4), rounded up to multiples of 128 and 8, at least 16."""
    mean = max(m // n_r, 4)
    return (max(((2 * mean + 127) // 128) * 128, 16),
            max(((3 * mean // 2 + 7) // 8) * 8, 16))


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [x, y, z, w] -> rotation matrix."""
    x, y, z, w = q.tolist()
    return torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
        dtype=torch.float64)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b of [x, y, z, w] quaternions."""
    x1, y1, z1, w1 = a.tolist()
    x2, y2, z2, w2 = b.tolist()
    return torch.tensor([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                         w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dtype=torch.float64)


def quat_angle_deg(q: torch.Tensor) -> float:
    return math.degrees(2.0 * math.atan2(float(q[:3].norm()), float(q[3])))


def horn_increment(mv: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                   c: float, estimate_scale: bool):
    """(qk, tk, sk) of Horn's closed form over weighted pairs (mv, fx) (n, 3)."""
    sw = w.sum()
    wn = (w / sw)[:, None]
    mean_m, mean_f = (mv * wn).sum(0), (fx * wn).sum(0)
    dm, df = (mv - mean_m) * c, (fx - mean_f) * c
    S = ((dm * w[:, None]).T @ df).double()  # S[i, j] = sum w m'_i f'_j
    ff = float((w * (df * df).sum(1)).sum())
    mm = float((w * (dm * dm).sum(1)).sum())
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = S.tolist()
    N = torch.tensor([
        [Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz, Syz - Szy],
        [Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy, Szx - Sxz],
        [Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz, Sxy - Syx],
        [Syz - Szy, Szx - Sxz, Sxy - Syx, Sxx + Syy + Szz]], dtype=torch.float64)
    qk = torch.linalg.eigh(N)[1][:, -1]
    qk = qk / qk.norm()
    qk = -qk if qk[3] < 0 else qk
    sk = math.sqrt(ff / mm) if estimate_scale and mm > 0 else 1.0
    tk = mean_f.double().cpu() - sk * (quat_matrix(qk) @ mean_m.double().cpu())
    return qk, tk, sk


def plane_increment(mv: torch.Tensor, fx: torch.Tensor, nf: torch.Tensor,
                    w: torch.Tensor, damping: float = 1e-6):
    """(qk, tk, 1) of one damped Gauss-Newton step of
    sum w ((R m + t - f) . n)^2, the rotation in units of
    CHARACTERISTIC_LENGTH_MM."""
    r = ((mv - fx) * nf).sum(1)
    J = torch.cat([nf, torch.linalg.cross(mv, nf, dim=1) / CHARACTERISTIC_LENGTH_MM], 1)
    Jw = J * w[:, None]
    H = (Jw.T @ J).double().cpu() + damping * torch.eye(6, dtype=torch.float64)
    b = (Jw.T @ r[:, None]).double().cpu()[:, 0]
    delta = -torch.linalg.solve(H, b)
    omega = delta[3:] / CHARACTERISTIC_LENGTH_MM
    angle = float(omega.norm())
    if angle <= 1e-12:
        qk = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    else:
        axis = omega / angle
        qk = torch.cat([math.sin(angle / 2) * axis,
                        torch.tensor([math.cos(angle / 2)], dtype=torch.float64)])
        qk = qk / qk.norm()
    return qk, delta[:3], 1.0


class RBCIndex:
    """Representatives and capacity-limited bins over the fixed set."""

    def __init__(self, fixed: torch.Tensor, n_r: int, alpha: float,
                 normals: torch.Tensor | None = None):
        dev = fixed.device
        self.w = metric_weights(alpha, dev)
        self.reps = fixed[representative_indices(fixed.shape[0], n_r).to(dev)]
        self.cap, self.query_cap = capacities(fixed.shape[0], n_r)
        members = bins_in_index_order(nearest_rep(fixed, self.reps, self.w), n_r, self.cap)
        valid = members >= 0
        safe = members.clamp(min=0)
        geometry = fixed[:, :3].abs().sum(1) > 0
        self.valid = valid & geometry[safe]
        self.bins = fixed[safe]  # (n_r, cap, 8)
        bc = self.bins - self.reps[:, None, :]
        self.bins_cw = bc * self.w
        self.sq_b = torch.where(self.valid, (self.bins_cw * bc).sum(-1),
                                torch.full_like(self.valid, math.inf, dtype=torch.float32))
        self.bin_normals = None if normals is None else normals[safe]

    def match(self, tm: torch.Tensor, has_geometry: torch.Tensor):
        """Nearest fixed point in its representative's bin of each searched
        moving point ``tm`` (m, 8) whose raw point ``has_geometry``: (query
        indices (k,), matched bin rows (k, 8), matched normals (k, 3) or
        None, d^2 (k,))."""
        n_r = self.reps.shape[0]
        qmembers = bins_in_index_order(nearest_rep(tm, self.reps, self.w), n_r,
                                       self.query_cap)
        qvalid = qmembers >= 0
        q = tm[qmembers.clamp(min=0)] - self.reps[:, None, :]  # (n_r, cq, 8)
        sq_q = (q * self.w * q).sum(-1)
        block = max(1, CELLS // (self.query_cap * self.cap))
        best, slot = [], []
        for s in range(0, n_r, block):
            d2 = (sq_q[s:s + block, :, None] + self.sq_b[s:s + block, None, :]
                  - 2.0 * torch.bmm(q[s:s + block], self.bins_cw[s:s + block].transpose(1, 2)))
            b, i = torch.min(d2, dim=2)
            best.append(b)
            slot.append(i)
        best, slot = torch.cat(best), torch.cat(slot)
        ok = qvalid & torch.isfinite(best) & has_geometry[qmembers.clamp(min=0)]
        rows = torch.arange(n_r, device=tm.device)[:, None].expand_as(slot)
        matched = self.bins[rows[ok], slot[ok]]
        normals = None if self.bin_normals is None else self.bin_normals[rows[ok], slot[ok]]
        return qmembers[ok], matched, normals, best[ok].clamp(min=0.0)


def register(fixed: torch.Tensor, moving: torch.Tensor, cfg: dict,
             fixed_normals: torch.Tensor | None = None,
             run_to: int = 0) -> dict:
    """ICP of ``moving`` onto ``fixed`` ((m, 8) float32) under ``cfg`` (the
    configuration file's ``icp`` section). Runs until it stops by its own
    test and, past that, until iteration ``run_to``.

    Returns {"k": the iteration it stopped at, "poses": [(q (4,), t (3,), s)
    float64 after each iteration]}.
    """
    plane = cfg["objective"] == "plane"
    if plane and fixed_normals is None:
        raise ValueError("the plane objective needs the fixed normals")
    index = RBCIndex(fixed, cfg["n_r"], cfg["alpha"], fixed_normals if plane else None)
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    t = torch.zeros(3, dtype=torch.float64)
    s = 1.0
    has_geometry = moving[:, :3].abs().sum(1) > 0
    poses, k_stop = [], 0
    while len(poses) < cfg["max_iterations"] and (not k_stop or len(poses) < run_to):
        A = (s * quat_matrix(q)).to(torch.float32).to(fixed.device)
        tm = moving.clone()
        tm[:, :3] = moving[:, :3] @ A.T + t.to(torch.float32).to(fixed.device)
        qi, matched, normals, d2 = index.match(tm, has_geometry)
        wgt = 100.0 / (100.0 + d2) if cfg["weighted"] else torch.ones_like(d2)
        mv = tm[qi, :3]
        if plane:
            qk, tk, sk = plane_increment(mv, matched[:, :3], normals, wgt)
        else:
            qk, tk, sk = horn_increment(mv, matched[:, :3], wgt, cfg["c"],
                                        cfg["estimate_scale"])
        q = quat_mul(qk, q)
        q = q / q.norm()
        t = sk * (quat_matrix(qk) @ t) + tk
        s = sk * s
        poses.append((q.clone(), t.clone(), s))
        if not k_stop and (len(poses) == cfg["max_iterations"] or (
                quat_angle_deg(qk) < cfg["angle_threshold_deg"]
                and float(tk.norm()) < cfg["translation_threshold_mm"])):
            k_stop = len(poses)
    return {"k": k_stop, "poses": poses}
