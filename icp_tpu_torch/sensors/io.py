"""Point-cloud binary IO (port of ``icp_tpu.sensors.io``, numpy only).

The reference's format: raw little-endian float32 binaries of 307200 x 8
floats (640 x 480 8-D points), as its frame grabber writes them
(src/kinect_frame_grabber.cpp:268-274) and its examples load them
(examples/step_by_step.cpp:298-338). ``icp_tpu_torch.runtime.native`` has
the faster mmap codec; these are its fallback and the format's oracle.
"""

from __future__ import annotations

import os

import numpy as np

CLOUD_POINTS = 640 * 480


def read_cloud_bin(path: str | os.PathLike) -> np.ndarray:
    """Read a reference-format .bin cloud -> (n, 8) float32."""
    data = np.fromfile(path, dtype="<f4")
    if data.size % 8 != 0:
        raise ValueError(f"{path}: size {data.size} not a multiple of 8 floats")
    return data.reshape(-1, 8)


def write_cloud_bin(path: str | os.PathLike, cloud8: np.ndarray) -> None:
    """Write an (n, 8) cloud in the reference's raw float32 format."""
    arr = np.ascontiguousarray(cloud8, dtype="<f4")
    if arr.ndim != 2 or arr.shape[1] != 8:
        raise ValueError(f"expected (n, 8) cloud, got {arr.shape}")
    arr.tofile(path)


def write_ply(path: str | os.PathLike, cloud8: np.ndarray,
              skip_invalid: bool = True) -> None:
    """Dump a cloud as ASCII PLY (positions + colours) for external viewers."""
    pts = np.asarray(cloud8)
    if skip_invalid:
        pts = pts[np.abs(pts[:, :3]).sum(1) > 0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        rgb = np.clip(pts[:, 4:7] * 255, 0, 255).astype(np.uint8)
        for p, c in zip(pts, rgb):
            f.write(f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f} {c[0]} {c[1]} {c[2]}\n")
