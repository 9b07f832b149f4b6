"""Photogeometric 8-D distances (port of ``icp_tpu.ops.distance``).

    d^2(x, x') = ||x_g - x'_g||^2 + alpha * ||x_p - x'_p||^2

over the geometric lanes 0:3 and the photometric lanes 4:7; the
homogeneous lanes 3 and 7 carry metric weight 0.
"""

from __future__ import annotations

import torch


def metric_weights(alpha, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-lane weights [1, 1, 1, 0, alpha, alpha, alpha, 0] of the metric."""
    a = torch.as_tensor(alpha, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.stack([one, one, one, zero, a, a, a, zero])


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """(m, n) blended squared distances between (m, 8) and (n, 8) points,
    clamped at 0, by the quadratic expansion |a|^2 + |b|^2 - 2 a.b.

    Both sets are first centered on b's centroid: distances are invariant
    under a common translation, and the smaller |p|^2 shrinks the float32
    cancellation error of the expansion (coordinates of ~2000 mm would
    otherwise leave ~0.5 absolute error in d^2). The product runs in full
    float32 (the package disables TF32 on import).
    """
    center = torch.mean(b, dim=0)
    a = a - center
    b = b - center
    w = metric_weights(alpha, a.dtype, a.device)
    aw = a * w
    sq_a = torch.sum(aw * a, dim=-1)
    sq_b = torch.sum((b * w) * b, dim=-1)
    cross = aw @ b.T
    d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * cross
    return torch.clamp(d2, min=0.0)
