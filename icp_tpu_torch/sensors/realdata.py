"""Real-sensor-data observations: LiDAR DEM geometry + photographic texture
(port of ``icp_tpu.sensors.realdata``, numpy only, bitwise the JAX
package's).

The world surface is the USGS airborne-LiDAR Jacksboro-fault DEM
(``data/real/jacksboro_fault_dem.npz``), scaled to tabletop millimeters and
textured with the Grace Hopper photograph, sampled densely once. Each
observation reprojects it through the reference's pinhole model
(src/kinect_frame_grabber.cpp:246-264 convention) with a painter's
z-buffer, so a second viewpoint carries realistic resampling, occlusion and
hole artifacts; holes stay invalid (zero depth).

The photograph is read from ``sensors/data/grace_hopper.png``: the pixels
of ``data/real/grace_hopper.jpg`` as a JPEG decoder gives them, stored
losslessly, so no image library is needed (the card's machine has none).
Host-side numpy by construction (file IO + scatter z-buffer); the frames go
to the card where the next step needs them.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from icp_tpu_torch.sensors import _png
from icp_tpu_torch.sensors.pinhole import CX, CY, FOCAL, HEIGHT, WIDTH

_HERE = os.path.dirname(os.path.abspath(__file__))
_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "data", "real")
PHOTO = os.path.join(_HERE, "data", "grace_hopper.png")


@lru_cache(maxsize=1)
def load_dem() -> np.ndarray:
    """(344, 403) float32 real elevations in meters (USGS LiDAR DEM)."""
    with np.load(os.path.join(_DATA_DIR, "jacksboro_fault_dem.npz")) as d:
        return d["elevation"].astype(np.float32)


@lru_cache(maxsize=1)
def load_photo() -> np.ndarray:
    """(600, 512, 3) float32 real photograph in [0, 1]."""
    return np.asarray(_png.read_png(PHOTO), dtype=np.float32) / 255.0


def _bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Sample img (H, W[, C]) at fractional (ys, xs), clamped borders."""
    h, w = img.shape[:2]
    ys = np.clip(ys, 0.0, h - 1.0)
    xs = np.clip(xs, 0.0, w - 1.0)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[..., None] if img.ndim == 3 else ys - y0
    fx = (xs - x0)[..., None] if img.ndim == 3 else xs - x0
    return ((img[y0, x0] * (1 - fy) + img[y1, x0] * fy) * (1 - fx)
            + (img[y0, x1] * (1 - fy) + img[y1, x1] * fy) * fx)


def _grid(n: int):
    return np.meshgrid(np.linspace(0.0, 1.0, n, dtype=np.float32),
                       np.linspace(0.0, 1.0, n, dtype=np.float32), indexing="ij")


def terrain_surface(samples_per_axis: int = 1500,
                    z_mean: float = 1800.0,
                    relief_mm: float = 420.0,
                    extent_x: float = 2350.0,
                    extent_y: float = 1800.0) -> Tuple[np.ndarray, np.ndarray]:
    """Densely sampled world surface from the real terrain + photograph.

    Returns (points (N, 3) mm, rgb (N, 3) in [0, 1]): the DEM resampled on
    a ``samples_per_axis``-squared grid spanning +-extent/2 in world x/y,
    elevations mapped linearly onto ``relief_mm`` of depth relief about
    ``z_mean`` (higher ground is closer to the camera), coloured by the
    photograph stretched over the extent. The default extent covers the
    frustum at the far plane and the density (~2.2M samples, ~1.6 mm
    pitch) is about twice the pixel footprint at z ~ 1.8 m, so the splat
    leaves holes only at occlusions and the frame margins.
    """
    dem = load_dem()
    photo = load_photo()
    gy, gx = _grid(samples_per_axis)
    elev = _bilinear(dem, gy * (dem.shape[0] - 1), gx * (dem.shape[1] - 1))
    lo, hi = float(dem.min()), float(dem.max())
    rel = (elev - lo) / (hi - lo)  # [0, 1], real terrain shape
    x = (gx - 0.5) * extent_x
    y = (gy - 0.5) * extent_y
    z = z_mean + relief_mm * (0.5 - rel)  # high ground nearer
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    rgb = _bilinear(photo, gy * (photo.shape[0] - 1),
                    gx * (photo.shape[1] - 1)).reshape(-1, 3)
    return pts, rgb.astype(np.float32)


def wall_surface(samples_per_axis: int = 1500,
                 z_wall: float = 2000.0,
                 extent_x: float = 2350.0,
                 extent_y: float = 1800.0) -> Tuple[np.ndarray, np.ndarray]:
    """A geometrically degenerate frontal wall textured with the real
    photograph (the reference's kg_pc8d_wall regime on real image
    statistics)."""
    photo = load_photo()
    gy, gx = _grid(samples_per_axis)
    x = (gx - 0.5) * extent_x
    y = (gy - 0.5) * extent_y
    z = np.full_like(x, z_wall)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    rgb = _bilinear(photo, gy * (photo.shape[0] - 1),
                    gx * (photo.shape[1] - 1)).reshape(-1, 3)
    return pts, rgb.astype(np.float32)


def observe(points_w: np.ndarray, rgb: np.ndarray, q: np.ndarray,
            t: np.ndarray, height: int = HEIGHT, width: int = WIDTH,
            focal: float = FOCAL) -> np.ndarray:
    """Observe a world surface from camera pose (q, t) -> (H, W, 8) cloud.

    Painter's z-buffer: camera-frame points are projected through the
    pinhole model and written far to near, so each pixel keeps its nearest
    surface sample. Pixels hit by nothing stay zero-depth (invalid), the
    reference's invalid-point convention (kernels/icp_kernels.cl:50-51).
    (q, t) is world-from-camera: p_w = R(q) p_c + t.
    """
    x, y, z, w = np.asarray(q, np.float32)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    # camera frame = R^T (p_w - t), R^T because (q, t) is world-from-camera.
    p_c = (points_w - np.asarray(t, np.float32)) @ R
    z = p_c[:, 2]
    keep = z > 1.0
    p_c, col = p_c[keep], rgb[keep]
    z = p_c[:, 2]
    u = np.round(p_c[:, 0] * focal / z + CX).astype(np.int64)
    v = np.round(p_c[:, 1] * focal / z + CY).astype(np.int64)
    inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z = u[inside], v[inside], z[inside]
    p_c, col = p_c[inside], col[inside]

    order = np.argsort(-z, kind="stable")  # far first; near overwrites
    flat = v[order] * width + u[order]
    depth = np.zeros(height * width, np.float32)
    color = np.zeros((height * width, 3), np.float32)
    depth[flat] = z[order]
    color[flat] = col[order]

    cloud = np.zeros((height, width, 8), np.float32)
    d2 = depth.reshape(height, width)
    uu = np.arange(width, dtype=np.float32)[None, :]
    vv = np.arange(height, dtype=np.float32)[:, None]
    cloud[..., 0] = (uu - CX) * d2 / focal
    cloud[..., 1] = (vv - CY) * d2 / focal
    cloud[..., 2] = d2
    cloud[..., 3] = 1.0
    cloud[..., 4:7] = color.reshape(height, width, 3)
    cloud[..., 7] = 1.0
    return cloud


def terrain_frames(poses, surface: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Observations of the real-terrain surface from a pose sequence.

    ``poses`` yields (q (4,), t (3,)) world-from-camera pairs (numpy arrays
    or tensors on any device); the surface defaults to
    :func:`terrain_surface` and is sampled once.
    """
    pts, rgb = surface if surface is not None else terrain_surface()
    for q, t in poses:
        yield observe(pts, rgb, _numpy(q), _numpy(t))


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
