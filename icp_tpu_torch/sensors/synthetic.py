"""Synthetic Kinect-like RGB-D renderer (port of the rendering part of
``icp_tpu.sensors.synthetic``).

An analytic ray-traced scene (textured planes + spheres) rendered through
the reference's pinhole model from any camera pose, so frame pairs come with
exact ground-truth transforms. One vectorized pass renders all 640 x 480
rays on the scene's device. Millimeters, camera looking down +z. The scene
and pose constructors put their tensors on the card unless the caller names
another device. :func:`synthetic_pair` (the flagship landmark pair) and
:func:`wavy_surface_pair` (the unorganized ground-truth pairs of the
scaled-shape gates) are made in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.icp.quaternion import qidentity, qrotate
from icp_tpu_torch.sensors.pinhole import CX, CY, FOCAL, HEIGHT, WIDTH, backproject


class CameraPose(NamedTuple):
    """World-from-camera pose: p_world = R(q) p_cam + t."""

    q: torch.Tensor  # (4,) [x, y, z, w]
    t: torch.Tensor  # (3,) mm

    @staticmethod
    def identity(device="cuda"):
        return CameraPose(qidentity(torch.float32, device),
                          torch.zeros((3,), dtype=torch.float32, device=device))


class Scene(NamedTuple):
    """Analytic scene: planes (P, 4) rows [nx, ny, nz, d] with n.p = d, and
    spheres (K, 4) rows [cx, cy, cz, radius]."""

    planes: torch.Tensor
    spheres: torch.Tensor


def default_scene(n_spheres: int = 5, device="cuda") -> Scene:
    """Corner room + large close spheres: enough 3-D structure that
    point-to-point ICP is fully constrained."""
    planes = torch.tensor(
        [
            [0.0, 0.0, -1.0, -2400.0],  # back wall at z = 2400
            [-1.0, 0.0, 0.0, -900.0],  # side wall at x = -900
            [0.0, -1.0, 0.0, -700.0],  # floor at y = 700
        ],
        dtype=torch.float32, device=device)
    spheres = torch.tensor(
        [
            [-350.0, 120.0, 1500.0, 260.0],
            [300.0, -180.0, 1300.0, 220.0],
            [0.0, 260.0, 1700.0, 280.0],
            [-120.0, -260.0, 1100.0, 180.0],
            [520.0, 160.0, 1800.0, 260.0],
        ],
        dtype=torch.float32, device=device)[:n_spheres]
    return Scene(planes, spheres)


def wall_scene(device="cuda") -> Scene:
    """A single textured frontal wall (geometric registration is degenerate
    in-plane; only the photometric term pins it)."""
    return Scene(
        planes=torch.tensor([[0.0, 0.0, -1.0, -2000.0]], dtype=torch.float32,
                            device=device),
        spheres=torch.zeros((0, 4), dtype=torch.float32, device=device))


def _texture(p: torch.Tensor) -> torch.Tensor:
    """Procedural RGB texture of world coordinates (..., 3) -> (..., 3):
    smooth multi-frequency gradients, band-limited well above the landmark
    pitch so photometric matching sees a gradient, not aliasing."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = (0.5 + 0.25 * torch.sin(x / 70.0) + 0.2 * torch.sin(y / 110.0)
         + 0.1 * torch.sin((x - y) / 230.0))
    g = (0.5 + 0.25 * torch.cos(y / 90.0) + 0.2 * torch.cos(x / 140.0)
         + 0.1 * torch.cos((x + y) / 260.0))
    b = 0.5 + 0.25 * torch.sin((x + y) / 120.0) + 0.2 * torch.cos(z / 160.0)
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 1.0)


def render(scene: Scene, pose: CameraPose):
    """Ray-trace the scene -> (depth (H, W) mm, rgb (H, W, 3)).

    The ray through pixel (u, v) has camera direction [(u-cx)/f, (v-cy)/f, 1],
    so the hit's camera depth is the ray parameter itself (z = d)."""
    dev = scene.planes.device
    u = torch.arange(WIDTH, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(HEIGHT, dtype=torch.float32, device=dev)[:, None]
    d_cam = torch.stack([((u - CX) / FOCAL).expand(HEIGHT, WIDTH),
                         ((v - CY) / FOCAL).expand(HEIGHT, WIDTH),
                         torch.ones((HEIGHT, WIDTH), dtype=torch.float32, device=dev)],
                        dim=-1)
    D = qrotate(pose.q, d_cam)  # world-frame directions
    o = pose.t
    big = 1e10

    # Planes: s = (d - n.o) / (n.D).
    n = scene.planes[:, :3]
    d = scene.planes[:, 3]
    denom = torch.einsum("pk,hwk->hwp", n, D)
    ok = torch.abs(denom) > 1e-8
    s_pl = (d - n @ o)[None, None, :] / torch.where(ok, denom, torch.full_like(denom, 1e-8))
    s_pl = torch.where((s_pl > 1.0) & ok, s_pl, torch.full_like(s_pl, big))

    # Spheres: |o + sD - c|^2 = r^2.
    c = scene.spheres[:, :3]
    r = scene.spheres[:, 3]
    oc = o - c
    A = torch.sum(D * D, -1)[..., None]
    B = 2.0 * torch.einsum("hwk,sk->hws", D, oc)
    Cq = torch.sum(oc * oc, -1)[None, None, :] - r[None, None, :] ** 2
    disc = B * B - 4.0 * A * Cq
    s_sp = (-B - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * A)
    s_sp = torch.where((disc > 0.0) & (s_sp > 1.0), s_sp, torch.full_like(s_sp, big))

    s = torch.min(torch.cat([s_pl, s_sp], dim=-1), dim=-1).values
    hit = s < big
    p_world = o + s[..., None] * D
    rgb = torch.where(hit[..., None], _texture(p_world), torch.zeros_like(D))
    depth = torch.where(hit, s, torch.zeros_like(s))  # 0 = invalid, like Kinect
    return depth, rgb


def render_cloud(scene: Scene, pose: CameraPose) -> torch.Tensor:
    """Render and back-project to the CAMERA frame -> (H, W, 8) cloud, so
    registering frame B to frame A recovers the relative pose A_from_B."""
    depth, rgb = render(scene, pose)
    return backproject(depth, rgb)


def orbit_trajectory(n_frames: int, radius_mm: float = 60.0, yaw_rad: float = 0.06,
                     device="cuda") -> list[CameraPose]:
    """A gentle arc of camera poses for odometry chains: per-frame
    translation ~radius/n and yaw ~yaw/n, Kinect-scale inter-frame motion.
    The values are made in numpy float32 (bitwise the JAX package's
    ``orbit_trajectory``) and land on ``device``."""
    poses = []
    for i in range(n_frames):
        frac = i / max(n_frames - 1, 1)
        ang = yaw_rad * frac
        q = np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)], np.float32)
        t = np.array([radius_mm * np.sin(2 * np.pi * frac) * 0.5,
                      10.0 * np.sin(4 * np.pi * frac),
                      radius_mm * frac], np.float32)
        poses.append(CameraPose(torch.from_numpy(q).to(device),
                                torch.from_numpy(t).to(device)))
    return poses


def synthetic_pair(m: int, seed: int = 0):
    """Kinect-like 8-D landmark pair (random wavy surface + colour), numpy
    only: fixed and moving (m, 8) float32, the moving cloud the fixed one
    moved by +0.02 rad about z and t = (8, -5, 3) mm. Bitwise the pair of
    ``__graft_entry__._synthetic_pair`` of the JAX package's entry module.
    """
    rng = np.random.default_rng(seed)
    u = rng.uniform(-400, 400, m).astype(np.float32)
    v = rng.uniform(-300, 300, m).astype(np.float32)
    z = 1500 + 80 * np.sin(u / 90) + 60 * np.cos(v / 70)
    cloud = np.ones((m, 8), np.float32)
    cloud[:, :3] = np.stack([u, v, z], -1)
    cloud[:, 4] = 0.5 + 0.5 * np.sin(u / 40)
    cloud[:, 5] = 0.5 + 0.5 * np.cos(v / 55)
    cloud[:, 6] = np.clip((z - 1350) / 300.0, 0, 1)
    ang = 0.02
    ca, sa = np.cos(ang), np.sin(ang)
    R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
    moving = cloud.copy()
    moving[:, :3] = (cloud[:, :3] - np.array([8, -5, 3], np.float32)) @ R
    return cloud, moving


def wavy_surface_pair(m: int, seed_a: int = 1, seed_b: int = 2,
                      ang_rad: float = 0.004,
                      t_mm: tuple = (10.0, -6.0, 8.0)):
    """Ground-truth registration pair at any m (the scaled-shape gates).

    Two independent random samplings of the analytic wavy surface
    z = 1500 + 80 sin(u/90) + 60 cos(v/70), so correspondences are only
    approximate, and a known rigid transform applied to the second. numpy
    only, bitwise the JAX package's ``wavy_surface_pair``. Returns numpy
    ``(fixed, moving, q_gt, t_gt)`` with moving in the moving frame
    (p_m = R^T (p_w - t)), so ``register(fixed, moving)`` should recover
    ``(q_gt, t_gt)``.
    """
    def sample(seed):
        rng = np.random.default_rng(seed)
        u = rng.uniform(-400, 400, m).astype(np.float32)
        v = rng.uniform(-300, 300, m).astype(np.float32)
        z = 1500 + 80 * np.sin(u / 90) + 60 * np.cos(v / 70)
        cloud = np.ones((m, 8), np.float32)
        cloud[:, :3] = np.stack([u, v, z], -1)
        cloud[:, 4] = 0.5 + 0.5 * np.sin(u / 40)
        cloud[:, 5] = 0.5 + 0.5 * np.cos(v / 55)
        cloud[:, 6] = np.clip((z - 1350) / 300.0, 0, 1)
        return cloud

    fixed = sample(seed_a)
    world_b = sample(seed_b)
    q = np.array([0, np.sin(ang_rad), 0, np.cos(ang_rad)], np.float32)
    t = np.asarray(t_mm, np.float32)
    R = np.array([
        [1 - 2 * q[1] ** 2, 0, 2 * q[1] * q[3]],
        [0, 1, 0],
        [-2 * q[1] * q[3], 0, 1 - 2 * q[1] ** 2]], np.float32)
    moving = world_b.copy()
    moving[:, :3] = (world_b[:, :3] - t) @ R
    return fixed, moving, q, t
