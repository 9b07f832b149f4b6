"""Frame-to-frame RGB-D odometry chain (port of ``icp_tpu.slam.odometry``).

Each frame's cloud is in its own camera frame; ICP(frame_i -> frame_i+1)
estimates the relative pose prev_from_cur, and world poses accumulate as
world_from_cur = world_from_prev * prev_from_cur.

:func:`run_odometry` reads each frame's keyframe decision on the host.
:func:`odometry_chain_device` enqueues the whole sequence with no host read
until the caller reads its result: each frame's registration runs as
``ceil(max_iterations / CHUNK)`` chunks of masked steps, and steps past the
stop are frozen, so each frame's state equals ``icp_run``'s bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from icp_tpu_torch.icp.quaternion import qangle_deg, qidentity, qmul, qnormalize, qrotate
from icp_tpu_torch.icp.run import build_index, icp_run, register
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.ops.sampling import get_landmarks
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams
from icp_tpu_torch.slam import se3
from icp_tpu_torch.slam.se3 import Pose


@dataclass
class OdometryResult:
    """Trajectory estimate over a frame sequence.

    poses: world_from_camera pose per frame (frame 0 = identity).
    keyframes: indices of selected keyframes.
    relative: per-step ICP states (relative transform + iteration count).
    """

    poses: list[Pose] = field(default_factory=list)
    keyframes: list[int] = field(default_factory=list)
    relative: list[ICPState] = field(default_factory=list)


@dataclass(frozen=True)
class KeyframePolicy:
    """Keyframe selection: motion thresholds or a frame-count cap since the
    last keyframe (tuned for Kinect-scale motion)."""

    max_angle_deg: float = 2.0
    max_translation: float = 80.0  # mm
    max_gap: int = 10


def frame_to_landmarks(cloud8) -> torch.Tensor:
    """(480, 640, 8) or (307200, 8) frame -> (16384, 8) landmarks. A tensor
    stays on its device; any other array (a numpy frame) goes to the card."""
    if not isinstance(cloud8, torch.Tensor):
        cloud8 = torch.as_tensor(cloud8, device="cuda")
    return get_landmarks(cloud8.reshape(-1, 8)).contiguous()


def run_odometry(
    frames: list,
    params: ICPParams,
    config: ICPConfig,
    policy: KeyframePolicy = KeyframePolicy(),
    to_landmarks: Callable[..., torch.Tensor] = frame_to_landmarks,
) -> OdometryResult:
    """Chain ICP over consecutive frames.

    register(fixed=prev landmarks, moving=cur landmarks) maps the moving
    cloud onto the fixed one, so it returns prev_from_cur. The keyframe
    decision on the motion since the last keyframe is read on the host once
    per frame.

    Args:
      frames: camera-frame clouds ((480, 640, 8) or (n, 8)); tensors stay
        on their device, numpy frames go to the card.
    """
    prev_lms = to_landmarks(frames[0])
    result = OdometryResult()
    result.poses.append(Pose.identity(prev_lms.dtype, prev_lms.device))
    result.keyframes.append(0)
    last_kf_pose = result.poses[0]
    gap = 0

    for i in range(1, len(frames)):
        cur_lms = to_landmarks(frames[i])
        state = register(prev_lms, cur_lms, params, config)
        world = se3.compose(result.poses[-1], Pose(state.q, state.t))
        result.poses.append(world)
        result.relative.append(state)

        d = se3.relative(last_kf_pose, world)
        gap += 1
        if (float(qangle_deg(d.q)) > policy.max_angle_deg
                or float(torch.linalg.vector_norm(d.t)) > policy.max_translation
                or gap >= policy.max_gap):
            result.keyframes.append(i)
            last_kf_pose = world
            gap = 0
        prev_lms = cur_lms
    return result


def odometry_chain_device(lms_seq: torch.Tensor, params: ICPParams,
                          config: ICPConfig):
    """The whole odometry chain with no host read.

    Per consecutive pair: the RBC index over the previous frame, the full
    registration (``icp_run`` with ``reads=False``) and the world pose
    composition, all enqueued on the device of ``lms_seq``; the host waits
    only where the caller reads the result.

    Args:
      lms_seq: (T, m, 8) landmark sets of T consecutive frames.
    Returns:
      (world_q (T, 4), world_t (T, 3), rel_k (T-1,) iteration counts), on
      the device of ``lms_seq``.
    """
    dev, dtype = lms_seq.device, lms_seq.dtype
    params = params.to(dev)
    q_w, t_w = qidentity(dtype, dev), torch.zeros((3,), dtype=dtype, device=dev)
    qs, ts, ks = [q_w], [t_w], []
    for i in range(lms_seq.shape[0] - 1):
        index = build_index(lms_seq[i].contiguous(), params, config)
        st = icp_run(lms_seq[i + 1].contiguous(), index, params, config, reads=False)
        # world_from_cur = world_from_prev * prev_from_cur
        q_w, t_w = qnormalize(qmul(q_w, st.q)), qrotate(q_w, st.t) + t_w
        qs.append(q_w)
        ts.append(t_w)
        ks.append(st.k)
    k_empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.stack(qs), torch.stack(ts), torch.stack(ks) if ks else k_empty


def _host(p: Pose) -> Pose:
    """A pose's tensors on the CPU (numpy arrays become tensors)."""
    return Pose(torch.as_tensor(p.q).cpu(), torch.as_tensor(p.t).cpu())


def absolute_trajectory_error(est: list[Pose], gt: list[Pose]) -> float:
    """RMS translational ATE; both trajectories are expressed relative to
    their own frame 0, the common anchor, so no alignment is needed."""
    errs = [np.linalg.norm(_host(e).t.numpy() - _host(g).t.numpy())
            for e, g in zip(est, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def relative_pose_error(est: list[Pose], gt: list[Pose],
                        delta: int = 1) -> tuple[float, float]:
    """TUM-benchmark RPE (Sturm et al., IROS 2012): drift per ``delta``
    frames. For every i, E_i = (G_i^-1 G_{i+delta})^-1 (X_i^-1 X_{i+delta}).

    Returns (RMS translational RPE in the trajectory's length unit, RMS
    rotational RPE in degrees).
    """
    est, gt = [_host(p) for p in est], [_host(p) for p in gt]
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        rel_e = se3.relative(est[i], est[i + delta])
        rel_g = se3.relative(gt[i], gt[i + delta])
        err = se3.compose(se3.inverse(rel_g), rel_e)
        t_errs.append(float(np.linalg.norm(err.t.numpy())))
        r_errs.append(float(qangle_deg(err.q)))
    if not t_errs:
        raise ValueError("trajectory shorter than delta")
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
