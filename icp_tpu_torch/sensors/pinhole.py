"""Kinect pinhole camera model (port of ``icp_tpu.sensors.pinhole``,
back-projection only).

For pixel (u, v) with depth d (mm): x = (u - 319.5) d / 595,
y = (v - 239.5) d / 595, z = d; packed as [x, y, z, 1, r, g, b, 1].
"""

from __future__ import annotations

import torch

FOCAL = 595.0
CX = 319.5
CY = 239.5
WIDTH = 640
HEIGHT = 480


def backproject(depth: torch.Tensor, rgb: torch.Tensor, fx: float = FOCAL,
                fy: float = FOCAL, cx: float = CX, cy: float = CY) -> torch.Tensor:
    """(H, W) depth in mm (0 = invalid) and (H, W, 3) colour in [0, 1] ->
    (H, W, 8) cloud; invalid pixels get all-zero geometry."""
    h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    ones = torch.ones_like(depth)
    return torch.stack(
        [x, y, depth, ones, rgb[..., 0], rgb[..., 1], rgb[..., 2], ones], dim=-1)
