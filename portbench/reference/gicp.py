"""The reference of the GICP configurations: Generalized-ICP (Segal, Haehnel
and Thrun, "Generalized-ICP", RSS 2009) over ``icp.py``'s Random Ball Cover
correspondences, with kNN normals (``normals.knn_normals``) of both frames,
each frame's made once a run and kept by its index.

Every point carries the disk covariance of its surface, C = I - (1 - eps)
n n^T (thin along its normal n, eps the configuration's ``gicp_epsilon``; a
zero normal leaves C = I). Each iteration matches the moving points under
the accumulated transform (R, t) as ``icp.py`` does, weights each pair by
100 / (100 + d^2) where the configuration is weighted, and takes one damped
Gauss-Newton step of the paper's objective

    sum_i w_i r_i^T W_i r_i,  r_i = R m_i + t - f_i,
    W_i = (C_f,i + R C_m,i R^T)^-1,

W_i held fixed over the step (the paper's plane-to-plane weight, the moving
normal rotated into the fixed frame), W_i an explicit 3x3 inverse. The
increment [t_k; omega] perturbs the moving points as R m + t -> R m + t +
t_k + omega x (R m + t), solved in ``icp.py``'s balanced units (omega in
units of CHARACTERISTIC_LENGTH_MM), and is composed into the accumulated
transform as ``icp.py``'s point-to-plane step is. The scale stays 1.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import icp as ref_icp
from portbench.reference import normals as ref_normals

# The keys of the ``icp`` section that this reference reads, or that leave
# the result it stands for as it is (Horn's solver and constant, and the
# scale, which GICP does not estimate).
MODELLED = {"n_r", "objective", "normal_mode", "rotation", "weighted", "estimate_scale",
            "alpha", "c", "max_iterations", "angle_threshold_deg",
            "translation_threshold_mm", "gicp_epsilon"}


def disk_weights(nf: torch.Tensor, nm: torch.Tensor, epsilon: float) -> torch.Tensor:
    """(k, 3, 3) W = (C_f + C_m)^-1 of (k, 3) fixed normals and moving normals
    already rotated into the fixed frame, in float64: the adjugate of the
    symmetric sum (rows a, b, c) over its determinant."""
    nf, nm = nf.double(), nm.double()
    eye = torch.eye(3, dtype=torch.float64, device=nf.device)
    e = 1.0 - epsilon
    M = 2.0 * eye - e * (nf[:, :, None] * nf[:, None, :] + nm[:, :, None] * nm[:, None, :])
    a, b, c = M.unbind(1)
    bc = torch.linalg.cross(b, c, dim=1)
    adj = torch.stack([bc, torch.linalg.cross(c, a, dim=1),
                       torch.linalg.cross(a, b, dim=1)], dim=2)
    return adj / (a * bc).sum(1)[:, None, None]


def gicp_increment(mv: torch.Tensor, fx: torch.Tensor, nf: torch.Tensor,
                   nm: torch.Tensor, w: torch.Tensor, epsilon: float,
                   damping: float = 1e-6):
    """(qk, tk, 1) of one damped Gauss-Newton step of sum w r^T W r over the
    (k, 3) moved points ``mv``, their matches ``fx``, the fixed normals
    ``nf`` and the rotated moving normals ``nm``."""
    L = ref_icp.CHARACTERISTIC_LENGTH_MM
    r = mv - fx
    W = (disk_weights(nf, nm, epsilon) * w.double()[:, None, None]).to(mv.dtype)
    # J = [I | -[mv]_x / L]: J [t_k; L omega] = t_k + omega x mv.
    x, y, z = (mv / L).unbind(1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    J = torch.stack([torch.stack([one, zero, zero, zero, z, -y], 1),
                     torch.stack([zero, one, zero, -z, zero, x], 1),
                     torch.stack([zero, zero, one, y, -x, zero], 1)], 1)  # (k, 3, 6)
    WJ = torch.bmm(W, J).reshape(-1, 6)
    H = (J.reshape(-1, 6).T @ WJ).double().cpu() + damping * torch.eye(6, dtype=torch.float64)
    b = (WJ.T @ r.reshape(-1, 1)).double().cpu()[:, 0]
    delta = -torch.linalg.solve(H, b)
    omega = delta[3:] / L
    angle = float(omega.norm())
    if angle <= 1e-12:
        qk = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    else:
        qk = torch.cat([math.sin(angle / 2) * omega / angle,
                        torch.tensor([math.cos(angle / 2)], dtype=torch.float64)])
        qk = qk / qk.norm()
    return qk, delta[:3], 1.0


def register(fixed: torch.Tensor, moving: torch.Tensor, cfg: dict,
             fixed_normals: torch.Tensor, moving_normals: torch.Tensor,
             run_to: int = 0) -> dict:
    """GICP of ``moving`` onto ``fixed`` ((m, 8) float32, normals (m, 3))
    under ``cfg``, until it stops by its own test and on to ``run_to``;
    returns as ``icp.register`` does."""
    index = ref_icp.RBCIndex(fixed, cfg["n_r"], cfg["alpha"], fixed_normals)
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    t = torch.zeros(3, dtype=torch.float64)
    has_geometry = moving[:, :3].abs().sum(1) > 0
    poses, k_stop = [], 0
    while len(poses) < cfg["max_iterations"] and (not k_stop or len(poses) < run_to):
        R = ref_icp.quat_matrix(q).to(torch.float32).to(fixed.device)
        tm = moving.clone()
        tm[:, :3] = moving[:, :3] @ R.T + t.to(torch.float32).to(fixed.device)
        qi, matched, nf, d2 = index.match(tm, has_geometry)
        wgt = 100.0 / (100.0 + d2) if cfg["weighted"] else torch.ones_like(d2)
        qk, tk, _ = gicp_increment(tm[qi, :3], matched[:, :3], nf, moving_normals[qi] @ R.T,
                                   wgt, cfg["gicp_epsilon"])
        q = ref_icp.quat_mul(qk, q)
        q = q / q.norm()
        t = ref_icp.quat_matrix(qk) @ t + tk
        poses.append((q.clone(), t.clone(), 1.0))
        if not k_stop and (len(poses) == cfg["max_iterations"] or (
                ref_icp.quat_angle_deg(qk) < cfg["angle_threshold_deg"]
                and float(tk.norm()) < cfg["translation_threshold_mm"])):
            k_stop = len(poses)
    return {"k": k_stop, "poses": poses}


def run(frames: torch.Tensor, pair, icp: dict, run_to: int, cache: dict,
        tf32: bool = False) -> dict:
    """The registration of ``pair`` (fixed, moving), as ``spec`` states the
    contract."""
    other = sorted(set(icp) - MODELLED)
    if icp["objective"] != "gicp" or icp.get("normal_mode") != "knn" or other \
            or "gicp_epsilon" not in icp:
        raise ValueError(f"the gicp reference does not compute objective "
                         f"{icp['objective']!r} with normals {icp.get('normal_mode')!r} "
                         f"and keys {other}, and needs gicp_epsilon: the configuration "
                         "has to name a reference that does")
    i, j = pair
    with ref_icp.precision(tf32):
        for f in pair:
            if f not in cache:
                cache[f] = ref_normals.knn_normals(frames[f])
        return register(frames[i], frames[j], icp, cache[i], cache[j], run_to=run_to)
