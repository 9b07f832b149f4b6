"""TUM RGB-D dataset format (port of ``icp_tpu.sensors.tum``).

A sequence directory holds ``rgb/`` and ``depth/`` PNG folders and the
``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt`` timestamp indexes. Depth
PNGs are 16-bit with 5000 units per meter; ground-truth rows are
``ts tx ty tz qx qy qz qw``. This module loads such sequences into (H, W, 8)
clouds (millimeters; TUM intrinsics by default), associates the streams by
nearest timestamp, writes a rendered sequence in the format, and scores an
estimated trajectory against the ground truth. The PNGs go through the
port's own codec (``sensors._png``), so no image library is needed; the
index handling is host-side Python and numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from icp_tpu_torch.sensors import _png

# TUM freiburg1 defaults; the landmark sampler assumes 640x480, as TUM's.
TUM_FX = 525.0
TUM_FY = 525.0
TUM_CX = 319.5
TUM_CY = 239.5
TUM_DEPTH_SCALE = 5000.0  # PNG units per meter


@dataclass
class TumSequence:
    """An associated TUM sequence: per-frame rgb/depth paths + ground truth."""

    root: str
    rgb_files: List[str]
    depth_files: List[str]
    timestamps: List[float]
    gt_t: Optional[np.ndarray] = None  # (T, 3) meters
    gt_q: Optional[np.ndarray] = None  # (T, 4) [x, y, z, w]

    def __len__(self):
        return len(self.rgb_files)


def _read_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _associate(a: List[Tuple[float, str]], b: List[Tuple[float, str]],
               max_dt: float = 0.02):
    """One-to-one nearest-timestamp association (the standard associate.py
    rule: candidate pairs sorted by |dt|, each element matched at most
    once)."""
    if not a or not b:
        return []
    candidates = []
    bi = 0
    for ai, (ts, _) in enumerate(a):
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ts) <= abs(b[bi][0] - ts):
            bi += 1
        for j in (bi - 1, bi, bi + 1):
            if 0 <= j < len(b) and abs(b[j][0] - ts) <= max_dt:
                candidates.append((abs(b[j][0] - ts), ai, j))
    candidates.sort()
    match_of = {}
    used_b = set()
    for _, ai, j in candidates:
        if ai in match_of or j in used_b:
            continue
        match_of[ai] = j
        used_b.add(j)
    return [(a[ai][0], a[ai][1], b[match_of[ai]][1]) for ai in sorted(match_of)]


def load_sequence(root: str, max_frames: Optional[int] = None,
                  max_dt: float = 0.02) -> TumSequence:
    """Parse rgb.txt / depth.txt (+ groundtruth.txt if present)."""
    rgb = _read_index(os.path.join(root, "rgb.txt"))
    depth = _read_index(os.path.join(root, "depth.txt"))
    assoc = _associate(rgb, depth, max_dt)
    if max_frames:
        assoc = assoc[:max_frames]

    seq = TumSequence(
        root=root,
        timestamps=[a[0] for a in assoc],
        rgb_files=[os.path.join(root, a[1]) for a in assoc],
        depth_files=[os.path.join(root, a[2]) for a in assoc],
    )

    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        if rows and seq.timestamps:
            gt = np.asarray(rows)
            # Nearest gt row per frame timestamp: searchsorted gives the
            # ceiling; compare against the row before and keep the closer.
            hi = np.clip(np.searchsorted(gt[:, 0], seq.timestamps), 0, len(gt) - 1)
            lo = np.clip(hi - 1, 0, len(gt) - 1)
            ts = np.asarray(seq.timestamps)
            idx = np.where(np.abs(gt[lo, 0] - ts) <= np.abs(gt[hi, 0] - ts), lo, hi)
            seq.gt_t = gt[idx, 1:4].astype(np.float32)
            seq.gt_q = gt[idx, 4:8].astype(np.float32)
    return seq


def load_cloud(rgb_path: str, depth_path: str,
               fx: float = TUM_FX, fy: float = TUM_FY,
               cx: float = TUM_CX, cy: float = TUM_CY,
               depth_scale: float = TUM_DEPTH_SCALE) -> np.ndarray:
    """One associated frame -> (H, W, 8) numpy cloud in millimeters."""
    from icp_tpu_torch.sensors.pinhole import backproject

    rgb = np.asarray(_png.read_png(rgb_path), dtype=np.float32) / 255.0
    depth_mm = _png.read_png(depth_path).astype(np.float32) / depth_scale * 1000.0
    return backproject(torch.from_numpy(depth_mm), torch.from_numpy(rgb),
                       fx=fx, fy=fy, cx=cx, cy=cy).numpy()


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_sequence(root: str, frames, poses) -> TumSequence:
    """Write (depth_mm, rgb) frames + ground-truth poses in TUM format
    (rgb/depth PNGs + index files + groundtruth.txt). ``frames`` yields
    ((H, W) depth in mm, (H, W, 3) rgb in [0, 1]) as tensors on any device
    or numpy arrays; ``poses`` yields objects with ``.q`` / ``.t`` (t in mm,
    written as TUM meters; depth as 5000-scale 16-bit PNGs)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, ((depth, rgb), pose) in enumerate(zip(frames, poses)):
        ts = float(i) * (1.0 / 30.0)
        depth_png = np.clip(_numpy(depth) / 1000.0 * TUM_DEPTH_SCALE,
                            0, 65535).astype(np.uint16)
        rgb_png = np.clip(_numpy(rgb) * 255, 0, 255).astype(np.uint8)
        rp = f"rgb/{ts:.6f}.png"
        dp = f"depth/{ts:.6f}.png"
        _png.write_png(os.path.join(root, rp), rgb_png)
        _png.write_png(os.path.join(root, dp), depth_png)
        rgb_lines.append(f"{ts:.6f} {rp}")
        depth_lines.append(f"{ts:.6f} {dp}")
        t = _numpy(pose.t) / 1000.0  # mm -> m
        q = _numpy(pose.q)
        gt_lines.append(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")

    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)]:
        with open(os.path.join(root, name), "w") as f:
            f.write("# TUM-format sequence written by icp_tpu_torch\n")
            f.write("\n".join(lines) + "\n")
    return load_sequence(root)


def write_synthetic_sequence(root: str, n_frames: int = 5, scene=None,
                             poses=None, device="cuda") -> TumSequence:
    """Render a synthetic sequence on ``device`` and write it in TUM format,
    for pipeline tests without external data (TUM meters in groundtruth,
    5000-scale depth PNGs). The renderer uses the reference's Kinect model,
    f = 595."""
    from icp_tpu_torch.sensors import synthetic

    scene = scene if scene is not None else synthetic.default_scene(device=device)
    if poses is None:
        poses = synthetic.orbit_trajectory(n_frames, radius_mm=50.0, yaw_rad=0.04,
                                           device=device)
    frames = (synthetic.render(scene, pose) for pose in poses)
    return write_sequence(root, frames, poses)


def sequence_clouds(seq: TumSequence, **intrinsics):
    """Iterate the (H, W, 8) numpy clouds of an associated sequence.

    ``intrinsics`` forwards to :func:`load_cloud` (fx, fy, cx, cy,
    depth_scale), so one camera's calibration applies to the whole
    sequence."""
    for rp, dp in zip(seq.rgb_files, seq.depth_files):
        yield load_cloud(rp, dp, **intrinsics)


def evaluate_trajectory(seq: TumSequence, est_q, est_t,
                        rpe_delta: int = 1, unit_scale: float = 1e-3):
    """The TUM evaluation of an estimated trajectory against the sequence's
    ground truth: (ATE_m, RPE_trans_m, RPE_rot_deg).

    Both trajectories are re-anchored to their frame 0 (the benchmark's
    alignment reduces to this for a shared anchor frame). ``est_q`` /
    ``est_t`` are (T, 4) / (T, 3) world poses in the registration unit (mm
    by default; ``unit_scale`` converts to the ground truth's meters), as
    numpy arrays or tensors; the poses are compared in float32 on the CPU.
    """
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.odometry import absolute_trajectory_error, relative_pose_error

    if seq.gt_t is None:
        raise ValueError("sequence has no ground truth")
    n = min(len(est_t), len(seq.gt_t))

    def to_rel(qs, ts):
        def pose(i):
            return se3.Pose(torch.as_tensor(qs[i], dtype=torch.float32),
                            torch.as_tensor(ts[i], dtype=torch.float32))
        p0 = pose(0)
        return [se3.relative(p0, pose(i)) for i in range(n)]

    est = to_rel(_numpy(est_q), _numpy(est_t).astype(np.float64) * unit_scale)
    gt = to_rel(seq.gt_q, seq.gt_t)
    ate = absolute_trajectory_error(est, gt)
    rpe_t, rpe_r = relative_pose_error(est, gt, delta=rpe_delta)
    return ate, rpe_t, rpe_r
