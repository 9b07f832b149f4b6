"""SE(3) utilities (port of ``icp_tpu.slam.se3``).

Poses are (q (4,) [x, y, z, w], t (3,)) world-from-camera pairs of tensors;
the tangent space is [rho (translation), phi (rotation)] with the
first-order approximations that pose-graph solvers use. Every function runs
on the device of the tensors it is handed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.icp.quaternion import (
    qconj,
    qidentity,
    qmul,
    qnormalize,
    qrotate,
    quat_to_matrix,
)


class Pose(NamedTuple):
    q: torch.Tensor  # (..., 4)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, device="cuda") -> "Pose":
        return Pose(qidentity(dtype, device), torch.zeros((3,), dtype=dtype, device=device))


def compose(a: Pose, b: Pose) -> Pose:
    """a * b: apply b first, then a."""
    return Pose(qnormalize(qmul(a.q, b.q)), qrotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qi = qconj(p.q)
    return Pose(qi, -qrotate(qi, p.t))


def relative(a: Pose, b: Pose) -> Pose:
    """a^-1 * b: the transform taking b's frame into a's."""
    return compose(inverse(a), b)


def exp(xi: torch.Tensor) -> Pose:
    """xi = [rho (3), phi (3)] -> Pose: the quaternion exponential of phi
    and t = rho.

    Differentiable through zero rotation: everything is a function of
    a2 = |phi|^2, with a Taylor branch below 1e-8 guarded by a second
    ``where`` on the argument, so the branch not taken never sees the
    0/0 whose gradient would be NaN (the pose graph and bundle adjustment
    take their Jacobians at xi = 0).
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    a2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = a2 < 1e-8
    angle = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    # sin(angle/2)/angle, Taylor: 1/2 - a2/48 + a2^2/3840
    s = torch.where(small, 0.5 - a2 / 48.0 + (a2 * a2) / 3840.0,
                    torch.sin(0.5 * angle) / angle)
    # cos(angle/2), Taylor: 1 - a2/8 + a2^2/384
    c = torch.where(small, 1.0 - a2 / 8.0 + (a2 * a2) / 384.0, torch.cos(0.5 * angle))
    return Pose(torch.cat([s * phi, c], dim=-1), rho)


def log(p: Pose) -> torch.Tensor:
    """Pose -> [rho, phi] (the inverse of :func:`exp` to first order),
    differentiable through the identity rotation by the same guarded
    Taylor branch in n2 = |q_vec|^2."""
    w = p.q[..., 3:4]
    vec = p.q[..., :3]
    n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = n2 < 1e-8
    norm = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    # f = 2 atan2(norm, w) / norm; Taylor (unit q, w ~ +-1): 2/w - 2 n2 / (3 w^3)
    f_closed = 2.0 * torch.atan2(norm, w) / norm
    safe_w = torch.where(torch.abs(w) > 1e-6, w, torch.ones_like(w))
    f_taylor = 2.0 / safe_w - 2.0 * n2 / (3.0 * safe_w ** 3)
    f = torch.where(small, f_taylor, f_closed)
    return torch.cat([p.t, vec * f], dim=-1)


def retract(p: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative retraction: exp(xi) * p."""
    return compose(exp(xi), p)


def apply(p: Pose, points: torch.Tensor) -> torch.Tensor:
    """Transform (..., 3) points by the pose."""
    return qrotate(p.q, points) + p.t


def rotation_matrix(p: Pose) -> torch.Tensor:
    return quat_to_matrix(p.q)
