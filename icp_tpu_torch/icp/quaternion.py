"""Quaternion / similarity-transform utilities (port of ``icp_tpu.icp.quaternion``).

Quaternions are ``[qx, qy, qz, qw]`` (vector part first), points are rotated
with the reference's cross-product form ``p' = p + 2 v x (v x p + w p)``, and
similarity transforms are ``p' = s * R(q) * p + t``.
"""

from __future__ import annotations

import torch


def qidentity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion [0, 0, 0, 1], made on the device (a tensor
    copied from host memory would wait for the stream)."""
    return (torch.arange(4, device=device) == 3).to(dtype)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2; ``R(q1 * q2) == R(q1) @ R(q2)``."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) ``p`` (..., 3) by the unit quaternion ``q`` (4,)."""
    v = q[..., :3]
    w = q[..., 3:4]
    inner = _cross(v, p) + w * p
    return p + 2.0 * _cross(v, inner)


def qangle_deg(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a unit quaternion in degrees:
    ``180/pi * 2 * atan2(|q_vec|, q_w)``."""
    vec_norm = torch.linalg.vector_norm(q[..., :3], dim=-1)
    return torch.rad2deg(2.0 * torch.atan2(vec_norm, q[..., 3]))


def qaxis(q: torch.Tensor) -> torch.Tensor:
    """Rotation axis of a unit quaternion (a unit vector; arbitrary at a
    zero angle)."""
    v = q[..., :3]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, torch.ones_like(n))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [x, y, z, w] -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion [x, y, z, w], w >= 0.

    Branchless Shepperd's method, as in the JAX package: all four candidate
    solutions are built and the best-conditioned one is selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    sw = torch.sqrt(qw2 + 1e-30)
    cand_w = torch.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                          (m10 - m01) / (2 * sw), sw / 2], -1)
    sx = torch.sqrt(qx2 + 1e-30)
    cand_x = torch.stack([sx / 2, (m01 + m10) / (2 * sx),
                          (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], -1)
    sy = torch.sqrt(qy2 + 1e-30)
    cand_y = torch.stack([(m01 + m10) / (2 * sy), sy / 2,
                          (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], -1)
    sz = torch.sqrt(qz2 + 1e-30)
    cand_z = torch.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                          sz / 2, (m10 - m01) / (2 * sz)], -1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = qnormalize(torch.gather(cands, -2, idx).squeeze(-2))
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def transform_points(points8: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """Apply ``p' = s * R(q) * p + t`` to the geometric half of (n, 8) points;
    columns 3:8 pass through."""
    new_xyz = s * qrotate(q, points8[..., :3]) + t
    return torch.cat([new_xyz, points8[..., 3:]], dim=-1)


def transform_points_matrix(points8: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a row-major 4x4 homogeneous transform (sR folded into R) to the
    geometric half of (n, 8) points, the reference's ``icpTransform_Matrix``:
    only x, y, z are rewritten; columns 3:8 pass through."""
    new_xyz = points8[..., :4] @ T[:3, :].T
    return torch.cat([new_xyz, points8[..., 3:]], dim=-1)


def similarity_to_matrix(q: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The 4x4 homogeneous matrix [[s R(q), t], [0, 1]]."""
    top = torch.cat([s * quat_to_matrix(q), t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom], dim=0)


def pack_T(q: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The reference's T-buffer layout [qx, qy, qz, qw, tx, ty, tz, s] (8,)."""
    return torch.cat([q, t, s.reshape(1)])


def unpack_T(T8: torch.Tensor):
    """Inverse of :func:`pack_T`: (q, t, s)."""
    return T8[:4], T8[4:7], T8[7]
