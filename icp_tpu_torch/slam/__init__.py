"""SLAM layer: SE(3) and the frame-to-frame odometry chain."""

from icp_tpu_torch.slam.se3 import Pose
from icp_tpu_torch.slam.odometry import (
    KeyframePolicy,
    absolute_trajectory_error,
    odometry_chain_device,
    run_odometry,
)
