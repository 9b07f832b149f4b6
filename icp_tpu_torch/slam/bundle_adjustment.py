"""Bundle adjustment with Schur-complement reduction (port of
``icp_tpu.slam.bundle_adjustment``; the sharded solver comes with
``icp_tpu_torch.parallel``).

Problem: keyframe poses X_k (world_from_camera) and map points p_l observed
as 3-D camera-frame measurements z_o (RGB-D gives depth, so observations are
3-D points, not 2-D projections):

    r_o = z_o - X_{cam(o)}^-1 p_{pt(o)}

The Gauss-Newton system has the classic BA structure: a dense 6N x 6N
camera block Hcc, block-diagonal 3x3 landmark blocks Hll and the sparse
camera-landmark coupling W. Landmarks are eliminated by the Schur
complement

    S  = Hcc - W Hll^-1 W^T ,   rhs = bc - W Hll^-1 bp

then the reduced camera system is solved densely (N is small) and the
landmarks are back-substituted independently.

Structure: per-observation Jacobians by forward-mode autodiff (3x6, 3x3);
observations grouped by landmark with a fixed max-degree capacity
(``rbc.grouping.group_by_bin``), so the landmark sums and the Schur cross
terms are sums over that table's slots. The JAX package scatter-adds onto
the cameras; here those sums are products with one-hot camera matrices,
so no floating-point atomics decide the bits and a solve repeats bit for
bit. No host read after :func:`check_max_degree`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from icp_tpu_torch.rbc.grouping import group_by_bin
from icp_tpu_torch.slam import se3


class BAProblem(NamedTuple):
    """Struct-of-arrays bundle-adjustment problem, on one device.

    Attributes:
      pose_q: (N, 4) keyframe orientations (world_from_camera).
      pose_t: (N, 3) keyframe positions.
      points: (L, 3) map points (world frame).
      obs_cam: (O,) keyframe index per observation.
      obs_point: (O,) map-point index per observation.
      obs_z: (O, 3) measured camera-frame point.
      obs_w: (O,) scalar weight per observation.
    """

    pose_q: torch.Tensor
    pose_t: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_point: torch.Tensor
    obs_z: torch.Tensor
    obs_w: torch.Tensor


def _residual(xi_cam, dp, pose: se3.Pose, point, z):
    """r = z - (retract(X, xi))^-1 (p + dp)."""
    X = se3.retract(pose, xi_cam)
    return z - se3.apply(se3.inverse(X), point + dp)


def _obs_jacobians(q, t, point, z):
    """(r0 (3,), A (3, 6), B (3, 3)) of one observation at zero updates."""
    def residual(xi, dp):
        r = _residual(xi, dp, se3.Pose(q, t), point, z)
        return r, r

    zero6 = torch.zeros((6,), dtype=point.dtype, device=point.device)
    zero3 = torch.zeros((3,), dtype=point.dtype, device=point.device)
    (A, B), r0 = jacfwd(residual, argnums=(0, 1), has_aux=True)(zero6, zero3)
    return r0, A, B


def _linearize(problem: BAProblem):
    cam, pt = problem.obs_cam, problem.obs_point
    r0, A, B = vmap(_obs_jacobians)(problem.pose_q[cam], problem.pose_t[cam],
                                    problem.points[pt], problem.obs_z)
    return r0, A, B, problem.obs_w[:, None, None]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) with a 1.0 at idx: a product with it sums onto the n
    slots deterministically."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _schur_system(problem: BAProblem, r0, A, B, w, g, damping: float):
    """Build (S (6N, 6N), rhs (6N,), Hll_inv (L, 3, 3), bp (L, 3), Cg
    (L, D, 6, 3), cam_g (L, D)): Cg holds each landmark's W blocks in its
    table's slots (0 in empty slots), cam_g their cameras (0 there)."""
    n = problem.pose_q.shape[0]
    L = problem.points.shape[0]

    At_w = A.transpose(1, 2) * w.transpose(1, 2)  # (O, 6, 3)
    Hcc_blocks = torch.matmul(At_w, A)  # (O, 6, 6)
    bc_blocks = torch.einsum("oij,oj->oi", At_w, r0)  # (O, 6)
    C = torch.matmul(At_w, B)  # (O, 6, 3): the W blocks per observation
    Bt_w = B.transpose(1, 2) * w.transpose(1, 2)
    Hll_blocks = torch.matmul(Bt_w, B)  # (O, 3, 3)
    bp_blocks = torch.einsum("oij,oj->oi", Bt_w, r0)  # (O, 3)

    # Observations grouped by landmark (``g``, from group_by_bin). ``member``
    # is undefined on empty slots, so every gathered term is masked there
    # before it is summed.
    member = g.member.long()
    valid = g.valid
    Hll = torch.where(valid[..., None, None], Hll_blocks[member], 0.0).sum(1)
    bp = torch.where(valid[..., None], bp_blocks[member], 0.0).sum(1)
    Hll = Hll + damping * torch.eye(3, dtype=A.dtype, device=A.device)
    Hll_inv, _ = torch.linalg.inv_ex(Hll)

    # Camera sums: one-hot camera matrices in place of scatter-adds.
    onehot = _one_hot(problem.obs_cam, n, A.dtype)  # (O, n)
    D = (onehot.T @ Hcc_blocks.reshape(-1, 36)).reshape(n, 6, 6)
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)
    Hcc = eye_n[:, None, :, None] * D[:, :, None, :]  # (n, 6, n, 6), D on the diagonal
    bc = onehot.T @ bc_blocks  # (n, 6)

    # Schur cross terms: V[l, a] = sum over the slots d of landmark l seen
    # by camera a of C[member] (L, n, 6, 3); W Hll^-1 W^T = sum_l V Hll_inv V^T.
    Cg = torch.where(valid[..., None, None], C[member], 0.0)  # (L, D, 6, 3)
    cam_g = torch.where(valid, problem.obs_cam[member], 0)  # (L, D)
    V = torch.einsum("lda,ldim->laim", _one_hot(cam_g, n, A.dtype), Cg)
    T = torch.einsum("laim,lmk->laik", V, Hll_inv)  # (L, n, 6, 3)
    cross = torch.einsum("laik,lbjk->aibj", T, V)  # (n, 6, n, 6)
    Hcc = Hcc - cross

    # rhs reduction: bc - W Hll^-1 bp.
    y = torch.einsum("lkm,lm->lk", Hll_inv, bp)  # (L, 3)
    bc = bc - torch.einsum("laim,lm->ai", V, y)

    S = Hcc.reshape(6 * n, 6 * n)
    rhs = bc.reshape(6 * n)
    return S, rhs, Hll_inv, bp, Cg, cam_g


def check_max_degree(obs_point, n_points: int, max_degree: int) -> int:
    """Validate that no landmark exceeds the fixed-degree capacity.

    The landmark sums, the Schur cross terms and the back-substitution
    group observations by landmark with a fixed ``max_degree`` capacity
    (group_by_bin); overflow observations would be SILENTLY dropped from
    them. Raises ValueError on overflow; returns the actual max degree.
    Reads ``obs_point`` on the host: call it before dispatch.
    """
    counts = np.bincount(np.asarray(torch.as_tensor(obs_point).cpu()), minlength=n_points)
    actual = int(counts.max()) if counts.size else 0
    if actual > max_degree:
        raise ValueError(
            f"landmark observation degree {actual} exceeds max_degree="
            f"{max_degree}: excess observations would be silently dropped "
            f"from the Schur cross terms - raise max_degree to >= {actual}")
    return actual


def ba_solve(problem: BAProblem, iterations: int = 5, max_degree: int = 8,
             damping: float = 1e-4, fix_first: bool = True) -> BAProblem:
    """Gauss-Newton BA with Schur elimination (single device).

    Validates the fixed-degree capacity on the host first
    (:func:`check_max_degree`), then enqueues ``iterations`` iterations
    with no host read."""
    check_max_degree(problem.obs_point, problem.points.shape[0], max_degree)
    return _ba_solve(problem, iterations, max_degree, damping, fix_first)


def _ba_solve(problem: BAProblem, iterations: int, max_degree: int,
                   damping: float, fix_first: bool) -> BAProblem:
    n = problem.pose_q.shape[0]
    dev, dtype = problem.pose_t.device, problem.pose_t.dtype
    anchor = torch.where(torch.arange(6 * n, device=dev) < 6, 1e12, 0.0).to(dtype)
    # The grouping of observations by landmark does not change.
    g = group_by_bin(problem.obs_point.to(torch.int32), problem.points.shape[0], max_degree)
    prob = problem
    for _ in range(iterations):
        r0, A, B, w = _linearize(prob)
        S, rhs, Hll_inv, bp, Cg, cam_g = _schur_system(prob, r0, A, B, w, g, damping)
        if fix_first:
            S = S + torch.diag(anchor)
        S = S + damping * torch.eye(6 * n, dtype=dtype, device=dev)
        x, _ = torch.linalg.solve_ex(S, rhs)
        dx_c = -x.reshape(n, 6)

        # Back-substitute the landmarks: dp = -Hll^-1 (bp + W^T dx_c).
        wtx = torch.einsum("ldim,ldi->lm", Cg, dx_c[cam_g])  # (L, 3)
        dp = -torch.einsum("lkm,lm->lk", Hll_inv, bp + wtx)

        new_pose = se3.retract(se3.Pose(prob.pose_q, prob.pose_t), dx_c)
        prob = prob._replace(pose_q=new_pose.q, pose_t=new_pose.t,
                             points=prob.points + dp)
    return prob


def demo_problem(n_cams: int = 32, n_points: int = 4096, max_degree: int = 8,
                 seed: int = 0, device="cuda") -> BAProblem:
    """Deterministic synthetic problem (a fixture shared by the tests and
    chip_smoke.py): ``n_cams`` cameras on an arc, each point seen by 2 to
    ``max_degree`` of them with 0.5 mm of noise, poses (all but the first)
    and points perturbed. Built on the CPU from a seeded numpy generator,
    then moved to ``device``, so every device gets the same problem bit
    for bit."""
    rng = np.random.default_rng(seed)
    ang = 0.02 * np.arange(n_cams)
    q = np.stack([np.zeros(n_cams), np.sin(ang / 2), np.zeros(n_cams), np.cos(ang / 2)], 1)
    t = np.arange(n_cams)[:, None] * np.array([20.0, 3.0, 5.0])
    poses = se3.Pose(torch.from_numpy(q.astype(np.float32)),
                     torch.from_numpy(t.astype(np.float32)))
    pts = np.stack([rng.uniform(-500, 500, n_points), rng.uniform(-400, 400, n_points),
                    rng.uniform(1200, 2200, n_points)], 1).astype(np.float32)
    cams = [rng.choice(n_cams, size=rng.integers(2, max_degree + 1), replace=False)
            for _ in range(n_points)]
    cam = torch.from_numpy(np.concatenate(cams).astype(np.int64))
    pid = torch.from_numpy(np.repeat(np.arange(n_points), [len(c) for c in cams]))
    z = se3.apply(se3.inverse(se3.Pose(poses.q[cam], poses.t[cam])), torch.from_numpy(pts)[pid])
    z = z + torch.from_numpy(rng.normal(0, 0.5, z.shape).astype(np.float32))
    xi = (rng.normal(size=(n_cams, 6)) * 0.01).astype(np.float32)
    xi[:, :3] *= 30.0
    xi[0] = 0.0
    init = se3.retract(poses, torch.from_numpy(xi))
    noisy = pts + rng.normal(0, 2.0, pts.shape).astype(np.float32)
    problem = BAProblem(init.q, init.t, torch.from_numpy(noisy), cam, pid, z,
                        torch.ones(len(cam)))
    return BAProblem(*(x.to(device) for x in problem))


def ba_cost(problem: BAProblem) -> torch.Tensor:
    r0, _, _, _ = _linearize(problem)
    return torch.sum(r0 * r0 * problem.obs_w[:, None])
