"""icp_tpu_torch — the PyTorch / CUDA port of icp_tpu.

Photogeometric ICP on 8-D points (x, y, z, 1, r, g, b, 1) stored as (n, 8)
float32 tensors. The package mirrors ``icp_tpu``'s layout and names; its hot
path runs hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at
the first CUDA call) on CUDA tensors and their plain PyTorch twins on CPU
tensors. It never imports jax or icp_tpu.

Ported so far: ``register(fixed8, moving8, params, config)`` for the POINT,
PLANE, symmetric PLANE and GICP objectives with grid normals or the kNN
normals of unorganized clouds (exact, or RBC-accelerated for LiDAR-scale
sweeps), on the fused and unfused RBC pipelines and on BRUTE
correspondence, with POWER / SVD / JACOBI rotation, WEIGHTED / REGULAR
weighting and the robust kernels; ``register_batch`` for a batch of pairs,
``icp.pyramid.register_pyramid`` for large motions, and the reference's apps
(``icp.pipeline.ICPStepByStep``, ``ICPRegistration``). Around them: the
sensors (pinhole model, renderer, real-terrain observations, guided filter,
cloud IO, the TUM RGB-D format, the native frame stream), the runtime
(configuration, timing, metrics, the native host library) and the odometry
front end (``slam.se3``; ``slam.odometry.run_odometry`` and
``odometry_chain_device``, which enqueues a whole sequence with no host
read), and the SLAM back end (``slam.mapping.SlamEngine`` with loop
closure, the pose-graph and bundle-adjustment solvers, session
checkpoints, ``parallel.resilience``'s bounded retries).

Geometry runs in full float32: importing the package disables TF32 for
matrix products and cuDNN, since TF32 shows up as ~0.5% coordinate error and
a broken nearest-neighbor order.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from icp_tpu_torch.runtime.config import (  # noqa: E402
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    RobustKernel,
    RotationMode,
    Weighting,
)
from icp_tpu_torch.icp.state import ICPState, identity_state  # noqa: E402
from icp_tpu_torch.icp.step import BruteTarget, icp_step  # noqa: E402
from icp_tpu_torch.icp.run import (  # noqa: E402
    build_index,
    build_target,
    icp_run,
    register,
    register_batch,
)
from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct  # noqa: E402
from icp_tpu_torch.rbc.search import rbc_search  # noqa: E402

__all__ = [
    "__version__",
    "BruteTarget",
    "Correspondence",
    "ICPConfig",
    "ICPParams",
    "ICPState",
    "Objective",
    "RBCIndex",
    "RobustKernel",
    "RotationMode",
    "Weighting",
    "build_index",
    "build_target",
    "icp_run",
    "icp_step",
    "identity_state",
    "rbc_construct",
    "rbc_search",
    "register",
    "register_batch",
]
