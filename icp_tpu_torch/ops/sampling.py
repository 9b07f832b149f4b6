"""Landmark and representative samplers (port of ``icp_tpu.ops.sampling``)."""

from __future__ import annotations

import torch

IMAGE_WIDTH = 640
IMAGE_HEIGHT = 480
LM_GRID = 128  # landmarks form a 128 x 128 grid -> 16384 points


def get_landmarks(cloud8: torch.Tensor) -> torch.Tensor:
    """(16384, 8) landmarks of a 640x480 cloud, the reference's ``getLMs``:

        landmark[r, l] = cloud[48 + 3r + 1, 64 + 4l + 1]

    Invalid (all-zero) points pass through.
    """
    img = cloud8.reshape(IMAGE_HEIGHT, IMAGE_WIDTH, 8)
    lms = img[49:49 + 3 * LM_GRID:3, 65:65 + 4 * LM_GRID:4]
    return lms.reshape(LM_GRID * LM_GRID, 8)


def sample_representative_indices(n: int, n_r: int,
                                  grid: tuple[int, int] | None = None,
                                  device=None) -> torch.Tensor:
    """(n_r,) int32 indices of the representatives within the landmark set.

    A perfect-square n is an organized side x side grid, sampled in 2-D with
    stride side/n_r per axis and a centered offset (step/2 - 1); other sizes
    use the 1-D analog. ``grid`` gives (n_ry, n_rx) for the 128x128 grid.
    """
    side = int(round(n ** 0.5))
    if side * side == n and side >= 4:
        if n == LM_GRID * LM_GRID and grid is not None:
            n_ry, n_rx = grid
        else:
            p = n_r.bit_length() - 1
            if (1 << p) == n_r:
                n_ry, n_rx = 1 << (p // 2), 1 << (p - p // 2)
            else:
                n_ry = n_rx = 0
        if n_ry and side % n_rx == 0 and side % n_ry == 0:
            step_x = side // n_rx
            step_y = side // n_ry
            ys = torch.arange(n_ry, device=device) * step_y + max(step_y // 2 - 1, 0)
            xs = torch.arange(n_rx, device=device) * step_x + max(step_x // 2 - 1, 0)
            return (ys[:, None] * side + xs[None, :]).reshape(-1).to(torch.int32)
    step = n // n_r
    return (torch.arange(n_r, device=device) * step
            + max(step // 2 - 1, 0)).to(torch.int32)
