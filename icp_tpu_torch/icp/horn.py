"""Horn absolute-orientation solvers (port of ``icp_tpu.icp.horn``).

S layout (``icpSijProducts`` order)::

    S11 = [Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz, sum|f'|^2, sum|m'|^2]

with ``S[3i+j] = sum_k m_dev[k,i] * f_dev[k,j]``; ``s_k = sqrt(S[9]/S[10])``.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.icp.quaternion import matrix_to_quat, qnormalize, qrotate

_POWER_SQUARINGS = 8  # N^(2^8) = 256 effective power iterations


def build_N(S9: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 N matrix in [x, y, z, w] quaternion basis."""
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S9.unbind(0)
    return torch.stack([
        torch.stack([Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz, Syz - Szy]),
        torch.stack([Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy, Szx - Sxz]),
        torch.stack([Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz, Sxy - Syx]),
        torch.stack([Syz - Szy, Szx - Sxz, Sxy - Syx, Sxx + Syy + Szz]),
    ])


def _sign_canonical(q: torch.Tensor) -> torch.Tensor:
    """q and -q are one rotation, but 2*atan2(|v|, w) is not sign-invariant:
    return the representative with w >= 0."""
    return q * torch.where(q[3] < 0, -1.0, 1.0)


def solve_rotation_power(S9: torch.Tensor) -> torch.Tensor:
    """Most-positive eigenvector of N by the shifted power method.

    Shift by the Gershgorin bound r = max_i sum_j |N_ij| so every eigenvalue
    is nonnegative (the most positive becomes the dominant one), take 8
    normalized squarings (256 power iterations), apply to ones(4), then one
    more multiply by N + rI and normalize (reference epilogue).
    """
    N = build_N(S9)
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    r = torch.max(torch.sum(torch.abs(N), dim=1))
    M = N + r * eye
    for _ in range(_POWER_SQUARINGS):
        M = M / torch.max(torch.abs(M))
        M = M @ M
    x = M @ torch.ones(4, dtype=N.dtype, device=N.device)
    return _sign_canonical(qnormalize((N + r * eye) @ x))


def solve_rotation_jacobi(S9: torch.Tensor) -> torch.Tensor:
    """Eigenvector of N's most positive eigenvalue by a full eigensolve."""
    _, vecs = torch.linalg.eigh(build_N(S9))  # ascending eigenvalues
    return _sign_canonical(qnormalize(vecs[:, -1]))


def solve_rotation_svd(S9: torch.Tensor) -> torch.Tensor:
    """R = V diag(1, 1, det(V U^T)) U^T from the SVD of the 3x3 S."""
    U, _, Vh = torch.linalg.svd(S9.reshape(3, 3))
    V = Vh.T
    d = torch.linalg.det(V @ U.T)
    B = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return matrix_to_quat(V @ B @ U.T)


_ROTATION_SOLVERS = {
    "power": solve_rotation_power,
    "svd": solve_rotation_svd,
    "jacobi": solve_rotation_jacobi,
}


def solve_step_transform(S11: torch.Tensor, mean_f: torch.Tensor,
                         mean_m: torch.Tensor, *, mode: str = "power",
                         estimate_scale: bool = True):
    """Incremental transform (q_k, t_k, s_k) of one ICP iteration.

    s_k = sqrt(S[9] / S[10]); t_k = mean_f - s_k R(q_k) mean_m.

    Degenerate frames (every pair masked out, all moments exactly 0) solve
    on an identity cross-covariance, so no NaN reaches the state: the
    no-information answer is identity q and unit s.

    Returns:
      (qk (4,), tk (3,), sk scalar).
    """
    degenerate = torch.max(torch.abs(S11)) <= 0.0
    one = torch.ones((), dtype=S11.dtype, device=S11.device)
    if estimate_scale:
        safe_den = torch.where(S11[10] > 0, S11[10], one)
        sk = torch.where(S11[10] > 0, torch.sqrt(S11[9] / safe_den), one)
    else:
        sk = one
    eye9 = torch.eye(3, dtype=S11.dtype, device=S11.device).reshape(9)
    S9_safe = torch.where(degenerate, eye9, S11[:9])
    qk = _ROTATION_SOLVERS[mode](S9_safe)
    tk = mean_f - sk * qrotate(qk, mean_m)
    return qk, tk, sk
