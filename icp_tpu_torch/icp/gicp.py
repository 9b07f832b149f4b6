"""Generalized-ICP (plane-to-plane) incremental solver (port of
``icp_tpu.icp.gicp``), the GICP tail of the unfused step.

Each point carries a disk covariance C = I - (1 - eps) n n^T, and each pair
is weighted by the 3x3 Mahalanobis matrix W_i = (C_f,i + R C_m,i R^T)^{-1}.
One Gauss-Newton step per iteration:

    r_i = R m_i + t - f_i,   J_i = [I_3 | -[R m_i]_x / L]
    (sum J^T W J) [t; L omega] = -(sum J^T W r)

Zero normals degrade C to the identity. The 3x3 inverse is the closed-form
adjugate; the 6x6 solve is ``icp.plane.solve_plane_system``.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.icp.plane import CHARACTERISTIC_LENGTH_MM, solve_plane_system


def disk_covariance_sum(n_f: torch.Tensor, n_m: torch.Tensor,
                        epsilon) -> torch.Tensor:
    """(n, 3, 3) M_i = C_f,i + C_m,i for (n, 3) fixed normals and moving
    normals already rotated into the fixed frame (zero rows allowed)."""
    eye = torch.eye(3, dtype=n_f.dtype, device=n_f.device)
    outer_f = n_f[:, :, None] * n_f[:, None, :]
    outer_m = n_m[:, :, None] * n_m[:, None, :]
    return 2.0 * eye - (1.0 - epsilon) * (outer_f + outer_m)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of (..., 3, 3) matrices via the adjugate
    (a singular matrix divides by 1 instead of 0)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    safe = torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    return adj / safe[..., None, None]


def gicp_system_partials(mv_xyz: torch.Tensor, f_xyz: torch.Tensor,
                         n_f: torch.Tensor, n_m: torch.Tensor, epsilon,
                         weights: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None):
    """(H (6, 6), b (6,)) of the GICP GN system, the rotation block scaled
    by 1 / CHARACTERISTIC_LENGTH_MM."""
    r = mv_xyz - f_xyz
    W = inv3x3(disk_covariance_sum(n_f, n_m, epsilon))
    w = torch.ones_like(mv_xyz[:, 0]) if weights is None else weights
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    W = W * w[:, None, None]

    L = CHARACTERISTIC_LENGTH_MM
    x, y, z = (mv_xyz / L).unbind(-1)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    # J_i = [I | -[p]_x],  -[p]_x = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    J = torch.stack([torch.stack([one, zero, zero, zero, z, -y], dim=-1),
                     torch.stack([zero, one, zero, -z, zero, x], dim=-1),
                     torch.stack([zero, zero, one, y, -x, zero], dim=-1)],
                    dim=-2)  # (n, 3, 6)
    WJ = torch.einsum("nkl,nlb->nkb", W, J)
    H = torch.einsum("nka,nkb->ab", J, WJ)
    b = torch.einsum("nkb,nk->b", WJ, r)
    return H, b


def solve_gicp(mv_xyz: torch.Tensor, f_xyz: torch.Tensor, n_f: torch.Tensor,
               n_m: torch.Tensor, epsilon,
               weights: torch.Tensor | None = None,
               mask: torch.Tensor | None = None, damping: float = 1e-6):
    """One GN step of the GICP objective -> (qk (4,), tk (3,)).

    Args:
      mv_xyz: (n, 3) transformed moving points (fixed frame).
      f_xyz: (n, 3) matched fixed points.
      n_f: (n, 3) fixed-surface normals (zero rows are isotropic).
      n_m: (n, 3) moving normals rotated into the fixed frame.
      epsilon: disk thickness (``ICPParams.gicp_epsilon``).
      weights, mask: optional per-pair weight and validity.
    """
    H, b = gicp_system_partials(mv_xyz, f_xyz, n_f, n_m, epsilon, weights, mask)
    return solve_plane_system(H, b, damping)
