"""icp_tpu_torch — the PyTorch / CUDA port of icp_tpu.

Photogeometric ICP on 8-D points (x, y, z, 1, r, g, b, 1) stored as (n, 8)
float32 tensors. The package mirrors ``icp_tpu``'s layout and names; its hot
path runs hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at
the first CUDA call) on CUDA tensors and their plain PyTorch twins on CPU
tensors. It never imports jax or icp_tpu.

Ported so far: the default registration,
``register(fixed8, moving8, ICPParams(), ICPConfig())`` (POINT objective,
RBC correspondence, fused POINT pipeline, POWER/SVD/JACOBI rotation,
WEIGHTED/REGULAR weighting).

Geometry runs in full float32: importing the package disables TF32 for
matrix products and cuDNN, since TF32 shows up as ~0.5% coordinate error and
a broken nearest-neighbor order.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

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
from icp_tpu_torch.icp.step import icp_step  # noqa: E402
from icp_tpu_torch.icp.run import build_index, icp_run, register  # noqa: E402
from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct  # noqa: E402

__all__ = [
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
    "icp_run",
    "icp_step",
    "identity_state",
    "rbc_construct",
    "register",
]
