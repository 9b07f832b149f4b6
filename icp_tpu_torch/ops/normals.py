"""Surface normals of organized landmark grids (port of the grid part of
``icp_tpu.ops.normals``).

:func:`grid_normals` takes central differences of the grid neighbours: the
16384 landmarks are a 128 x 128 sample of the organized image
(``ops.sampling.get_landmarks``), so no neighbourhood search is needed.
:func:`normals_for` dispatches on ``ICPConfig.normal_mode``; the kNN
estimators for unorganized clouds are ROADMAP slice 5.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.ops.sampling import LM_GRID


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


def normals_for(points8: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Normals by ``ICPConfig.normal_mode``.

    "grid": organized row-major square grid (error if the count is not a
    square). "auto": square counts of at least 8 x 8 are taken as organized
    and get grid normals, other counts zeros (no plane constraint). "knn" and
    "knn_rbc" (unorganized clouds) are ROADMAP slice 5.
    """
    if mode in ("knn", "knn_rbc"):
        raise NotImplementedError(
            f"normal_mode={mode!r} (kNN normals) is ROADMAP slice 5")
    m = points8.shape[0]
    side = int(m ** 0.5)
    if side * side == m and side >= 8:
        return grid_normals(points8, side)
    if mode == "grid":
        raise ValueError(f"normal_mode='grid' needs a square point count, got m={m}")
    return points8.new_zeros((m, 3))
