"""Point-to-plane incremental solver (port of ``icp_tpu.icp.plane``).

One linearized Gauss-Newton step of

    min_{omega, t}  sum_i w_i ((R m_i + t - f_i) . n_i)^2

with r_i = (m_i - f_i) . n_i and J_i = [n_i ; m_i x n_i]. Scale is not part
of this objective (s_k = 1).
"""

from __future__ import annotations

import torch

from icp_tpu_torch.icp.quaternion import qnormalize

# Unit balancing: the rotation columns m x n are O(|m|) ~ 2000 mm while the
# translation columns are O(1), so H would have cond ~ 4e6. Solving for
# [t; L omega] with the rotation columns divided by L rebalances it.
CHARACTERISTIC_LENGTH_MM = 1.0e3


def plane_system_partials(mv_xyz: torch.Tensor, f_xyz: torch.Tensor,
                          normals: torch.Tensor,
                          weights: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None):
    """(H (6, 6), b (6,)) of the GN normal system, the rotation block scaled
    by 1 / CHARACTERISTIC_LENGTH_MM."""
    r = torch.sum((mv_xyz - f_xyz) * normals, dim=-1)
    J = torch.cat([normals, torch.linalg.cross(mv_xyz, normals, dim=-1)
                   / CHARACTERISTIC_LENGTH_MM], dim=-1)
    w = torch.ones_like(r) if weights is None else weights
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    Jw = J * w[:, None]
    return Jw.T @ J, Jw.T @ r


def solve_plane_system(H: torch.Tensor, b: torch.Tensor,
                       damping: float = 1e-6):
    """Solve the damped 6x6 system -> (qk (4,), tk (3,)).

    ``torch.linalg.solve_ex`` does not check for singularity, so on CUDA it
    never syncs the host; H + damping I is positive definite.
    """
    H = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
    tk = delta[:3]
    omega = delta[3:] / CHARACTERISTIC_LENGTH_MM
    angle = torch.linalg.vector_norm(omega)
    small = angle <= 1e-12
    axis = omega / torch.where(small, torch.ones_like(angle), angle)
    half = 0.5 * angle
    qk = torch.cat([torch.sin(half) * axis, torch.cos(half).reshape(1)])
    # Built on the device: a tensor copied from host memory would sync.
    identity = torch.eye(4, dtype=H.dtype, device=H.device)[3]
    return qnormalize(torch.where(small, identity, qk)), tk


def solve_point_to_plane(mv_xyz: torch.Tensor, f_xyz: torch.Tensor,
                         normals: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None,
                         damping: float = 1e-6):
    """One GN step of the point-to-plane objective -> (qk, tk).

    Args:
      mv_xyz: (n, 3) transformed moving points.
      f_xyz: (n, 3) matched fixed points.
      normals: (n, 3) fixed-surface unit normals (zero rows constrain
        nothing).
      weights: optional (n,) residual weights.
      mask: optional (n,) validity mask.
    """
    H, b = plane_system_partials(mv_xyz, f_xyz, normals, weights, mask)
    return solve_plane_system(H, b, damping)
