"""Algorithm layer: quaternions, Horn solve, one step, the loop, the batch,
the pyramid and the app pipelines."""

from icp_tpu_torch.icp.horn import (
    build_N,
    solve_rotation_jacobi,
    solve_rotation_power,
    solve_rotation_svd,
    solve_step_transform,
)
from icp_tpu_torch.icp.pipeline import ICPRegistration, ICPStepByStep
from icp_tpu_torch.icp.plane import solve_point_to_plane
from icp_tpu_torch.icp.run import build_index, build_target, icp_run, register, register_batch
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.icp.step import icp_step
from icp_tpu_torch.icp.pyramid import register_pyramid, subsample_grid
