"""SLAM layer: SE(3), the odometry chain, the pose graph, bundle
adjustment, the mapping engine and its checkpoints."""

from icp_tpu_torch.slam.se3 import Pose
from icp_tpu_torch.slam.odometry import (
    KeyframePolicy,
    absolute_trajectory_error,
    odometry_chain_device,
    run_odometry,
)
from icp_tpu_torch.slam.pose_graph import PoseGraph, graph_from_poses, optimize
from icp_tpu_torch.slam.bundle_adjustment import BAProblem, ba_solve
from icp_tpu_torch.slam.mapping import SlamEngine
from icp_tpu_torch.slam.checkpoint import load_session, save_session
