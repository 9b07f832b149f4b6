"""The inputs of every cell: a pool of sensor frames along a closed
trajectory, made on the device from a seed, of one of two scenes.

RGB-D landmarks (``"grid"`` and ``"uniform"`` sampling) see a textured
surface. The surface is ``wavy_surface_pair``'s (the repo's scaled gates):
z = 1500 + 80 sin(u/90) + 60 cos(v/70) mm over u in [-400, 400], v in
[-300, 300], with the colour lanes r = 0.5 + 0.5 sin(u/40),
g = 0.5 + 0.5 cos(v/55), b = clip((z - 1350)/300, 0, 1). Each frame is an
independent sampling of it, seen from the frame's pose:

* ``"grid"`` sampling (an organized RGB-D landmark grid): one point per cell
  of a side x side grid over (u, v), at a uniform position inside the cell,
  row-major, so index-strided representatives cover the view evenly;
* ``"uniform"`` sampling: uniform (u, v).

A spinning LiDAR (``"spinning_lidar"`` sampling, the configuration's
``sensor`` and ``scene``) sees the inside of a hall: floor, ceiling, four
walls and a grid of round pillars, every ray of the sweep ending on one of
them. Its beams are spread evenly over the vertical field of view, its
columns evenly over 360 degrees of azimuth, the same in every sweep; a
point is the ray's first hit at its range plus Gaussian range noise, in
the sensor's coordinates. The
colour lanes, standing in for the sensor's reflectivity, vary slowly with
the hit's place in the hall. A sweep's points come in an order drawn from
the seed (an unorganized cloud).

The trajectory is closed: the first half of the pool's increments are drawn
from the seed, the second half undo them in reverse order, so frame P
coincides with frame 0 and the view never leaves the surface. The
increments' sizes are the same in every seed (the midpoints of equal
strata of the configuration's ranges); the seed draws their axes,
directions and order and the surface samples.

A run's pool comes from its seed, which also draws where in the pool's
cycle the window starts and which registrations are checked.

Frame i holds its points in its own coordinates, p = R_i^T (w - t_i), so
registering frame i+1 (moving) to frame i (fixed) recovers T_i^{-1} T_{i+1}.
"""

from __future__ import annotations

import math

import numpy as np
import torch

U_HALF, V_HALF = 400.0, 300.0


def _rotvec_to_matrix(w: np.ndarray) -> np.ndarray:
    """(3,) axis-angle -> (3, 3) rotation (Rodrigues), float64."""
    a = float(np.linalg.norm(w))
    if a == 0.0:
        return np.eye(3)
    k = w / a
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * (K @ K)


def _unit_vectors(rng: np.random.Generator, n: int) -> np.ndarray:
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def trajectory(seed: int, frames: int, rot_max: float, trans_max: float):
    """Poses (R (P, 3, 3), t (P, 3)) float64 of a closed trajectory of
    ``frames`` (even) poses, frame 0 at the identity."""
    if frames % 2:
        raise ValueError(f"the pool needs an even number of frames, got {frames}")
    rng = np.random.default_rng([seed, 1])
    half = frames // 2
    strata = (np.arange(half) + 0.5) / half
    angles = rot_max * rng.permutation(strata)
    dists = trans_max * rng.permutation(strata)
    inc = [(_rotvec_to_matrix(a * ax), d * dr) for a, ax, d, dr in zip(
        angles, _unit_vectors(rng, half), dists, _unit_vectors(rng, half))]
    # Undo the first half in reverse order: (R, t)^-1 = (R^T, -R^T t).
    inc += [(R.T, -R.T @ t) for R, t in reversed(inc)]
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for dR, dt in inc[:-1]:  # T_{i+1} = T_i o inc_i
        Rs.append(Rs[-1] @ dR)
        ts.append(Rs[-2] @ dt + ts[-1])
    return np.stack(Rs), np.stack(ts)


def surface_points(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 8) photogeometric points of the surface at (u, v)."""
    z = 1500.0 + 80.0 * torch.sin(u / 90.0) + 60.0 * torch.cos(v / 70.0)
    one = torch.ones_like(u)
    return torch.stack([u, v, z, one,
                        0.5 + 0.5 * torch.sin(u / 40.0),
                        0.5 + 0.5 * torch.cos(v / 55.0),
                        torch.clamp((z - 1350.0) / 300.0, 0.0, 1.0), one], dim=-1)


def sample_uv(gen: torch.Generator, frames: int, points: int, sampling: str,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """(u, v), each (frames, points) float32, of independent samplings."""
    r = torch.rand((2, frames, points), generator=gen, device=device)
    if sampling == "uniform":
        return (2 * r[0] - 1) * U_HALF, (2 * r[1] - 1) * V_HALF
    if sampling != "grid":
        raise ValueError(f"sampling must be grid or uniform, got {sampling!r}")
    side = math.isqrt(points)
    if side * side != points:
        raise ValueError(f"grid sampling needs a square point count, got {points}")
    idx = torch.arange(points, device=device)
    row, col = (idx // side).float(), (idx % side).float()
    u = (col + r[0]) * (2 * U_HALF / side) - U_HALF
    v = (row + r[1]) * (2 * V_HALF / side) - V_HALF
    return u, v


def sensor_rays(sensor: dict, device) -> torch.Tensor:
    """(beams x columns, 3) float32 unit directions of one sweep in the
    sensor's frame, beam-major: beams from the top of the vertical field of
    view down, columns from azimuth 0 on."""
    half = math.radians(sensor["vertical_fov_deg"]) / 2
    el = torch.linspace(half, -half, sensor["beams"], dtype=torch.float64, device=device)
    az = torch.arange(sensor["columns"], dtype=torch.float64, device=device) * (
        2 * math.pi / sensor["columns"])
    el, az = el[:, None], az[None, :]
    d = torch.stack(torch.broadcast_tensors(torch.cos(el) * torch.cos(az),
                                            torch.cos(el) * torch.sin(az),
                                            torch.sin(el)), dim=-1)
    return d.reshape(-1, 3).float()


def hall_range(origin: torch.Tensor, dirs: torch.Tensor, hall: dict) -> torch.Tensor:
    """(P, n) range, mm, of the first hit of each ray (origins (P, 3),
    directions (P, n, 3), unit) from inside the hall: the box
    ``half_extent_mm`` (x, y) by ``floor_mm`` .. ``ceiling_mm`` (z) and the
    vertical pillars of radius ``pillar_radius_mm`` at ``pillars_mm`` (x, y)."""
    o = origin[:, None, :]
    hi = torch.tensor([*hall["half_extent_mm"], hall["ceiling_mm"]], device=dirs.device)
    lo = torch.tensor([-hall["half_extent_mm"][0], -hall["half_extent_mm"][1],
                       hall["floor_mm"]], device=dirs.device)
    wall = torch.where(dirs > 0, hi, lo)
    r = torch.where(dirs != 0, (wall - o) / dirs, math.inf).amin(dim=-1)
    rad2 = hall["pillar_radius_mm"] ** 2
    dxy = dirs[..., :2]
    a = (dxy * dxy).sum(-1)
    for cx, cy in hall["pillars_mm"]:
        oc = o[..., :2] - torch.tensor([cx, cy], device=dirs.device)
        b = (dxy * oc).sum(-1)
        c = (oc * oc).sum(-1) - rad2
        disc = b * b - a * c
        hit = (-b - torch.sqrt(disc.clamp(min=0))) / a.clamp(min=1e-12)
        r = torch.where((disc > 0) & (hit > 0) & (a > 0), torch.minimum(r, hit), r)
    return r


def lidar_frames(gen: torch.Generator, config: dict, Rs, ts, device) -> torch.Tensor:
    """(P, beams x columns, 8) sweeps from the poses (Rs, ts), each sweep's
    points in an order drawn from ``gen``."""
    rays = sensor_rays(config["sensor"], device)
    R = torch.as_tensor(Rs, dtype=torch.float32, device=device)
    t = torch.as_tensor(ts, dtype=torch.float32, device=device)
    world_dirs = rays @ R.transpose(1, 2)  # (P, n, 3): R_i d
    r = hall_range(t, world_dirs, config["scene"])
    hits = t[:, None, :] + r[..., None] * world_dirs
    r = r + config["sensor"]["range_noise_mm"] * torch.randn(
        r.shape, generator=gen, device=device)
    x, y, z = hits.unbind(-1)
    one = torch.ones_like(x)
    out = torch.stack([*(r[..., None] * rays).unbind(-1), one,
                       0.5 + 0.5 * torch.sin(x / 1700.0), 0.5 + 0.5 * torch.cos(y / 1300.0),
                       0.5 + 0.5 * torch.sin((z + 900.0 * torch.sin(x / 2300.0)) / 700.0),
                       one], dim=-1)
    order = torch.argsort(torch.rand(out.shape[:2], generator=gen, device=device), dim=1)
    return torch.gather(out, 1, order[..., None].expand_as(out)).contiguous()


def make_pool(seed: int, config: dict, frames: int, device) -> dict:
    """The cell's frame pool: ``frames`` (P, m, 8) float32 on ``device``
    (each frame contiguous), and the poses (R, t) it was seen from."""
    m = config["points"]
    Rs, ts = trajectory(seed, frames, config["motion"]["rot_max_rad"],
                        config["motion"]["trans_max_mm"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    if config["sampling"] == "spinning_lidar":
        sensor = config["sensor"]
        if sensor["beams"] * sensor["columns"] != m:
            raise ValueError(f"{sensor['beams']} x {sensor['columns']} rays, not {m} points")
        return {"frames": lidar_frames(gen, config, Rs, ts, device), "R": Rs, "t": ts}
    u, v = sample_uv(gen, frames, m, config["sampling"], device)
    world = surface_points(u, v)
    del u, v
    R = torch.as_tensor(Rs, dtype=torch.float32, device=device)
    t = torch.as_tensor(ts, dtype=torch.float32, device=device)
    # p = R^T (w - t) as row vectors: (w - t) @ R.
    world[..., :3] = torch.bmm(world[..., :3] - t[:, None, :], R)
    return {"frames": world, "R": Rs, "t": ts}


def pair_truth(pool: dict, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) float64 of T_i^{-1} T_j: moving frame j into fixed frame i."""
    Ri, ti, Rj, tj = pool["R"][i], pool["t"][i], pool["R"][j], pool["t"][j]
    return Ri.T @ Rj, Ri.T @ (tj - ti)
