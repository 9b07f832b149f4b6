"""One ICP iteration (port of the fused branches of ``icp_tpu.icp.step``).

POINT:         transform + nearest rep (K1) -> grouping (sort + K2) ->
               [K4: adaptive robust scale] -> per-bin search, weights and
               moments (K3) -> Horn inputs -> rotation solve -> accumulate
PLANE / GICP:  the same front half with K7 building the Gauss-Newton system
               as per-bin moments -> 6x6 solve (s_k = 1) -> accumulate

The tensors' device selects the path: CUDA tensors run the kernels, CPU
tensors their plain twins.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.icp.horn import solve_step_transform
from icp_tpu_torch.icp.plane import CHARACTERISTIC_LENGTH_MM, solve_plane_system
from icp_tpu_torch.icp.quaternion import qmul, qnormalize, qrotate
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.kernels.fused_gn import gn_system_from_V
from icp_tpu_torch.ops.normals import normals_for
from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.search import rbc_gn_system, rbc_point_moments
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams, Objective, Weighting


def gn_mode(config: ICPConfig) -> str:
    """K7's mode for a normal-consuming objective."""
    if config.objective is Objective.GICP:
        return "gicp"
    return "plane_sym" if config.plane_symmetric else "plane"


def icp_step(state: ICPState, moving8, target: RBCIndex, params: ICPParams,
             config: ICPConfig,
             moving_normals: torch.Tensor | None = None) -> ICPState:
    """Run one ICP iteration and return the updated state.

    Args:
      state: accumulated transform state.
      moving8: (m, 8) ORIGINAL moving landmarks (the accumulated transform
        is re-applied from scratch each iteration).
      target: RBC index over the fixed landmarks (built with normals for
        PLANE / GICP).
      params: dynamic scalars.
      config: static configuration.
      moving_normals: optional (m, 3) moving-cloud normals for the symmetric
        PLANE and GICP objectives; ``icp_run`` computes them once, None
        computes them here.
    """
    weighted = config.weighting is Weighting.WEIGHTED
    robust = config.robust.value
    if config.needs_normals:
        mode = gn_mode(config)
        mnormals_rot = None
        if mode != "plane":
            if moving_normals is None:
                moving_normals = normals_for(moving8, config.normal_mode)
            mnormals_rot = qrotate(state.q, moving_normals)
        V = rbc_gn_system(
            target, moving8, state.q, state.t, state.s, params.alpha,
            config.query_capacity, mode=mode, weighted=weighted,
            robust=robust, robust_delta=params.robust_delta,
            robust_adaptive=config.robust_adaptive,
            gicp_eps=params.gicp_epsilon, mnormals_rot=mnormals_rot)
        H, b = gn_system_from_V(V, CHARACTERISTIC_LENGTH_MM)
        qk, tk = solve_plane_system(H, b)
        sk = torch.ones((), dtype=moving8.dtype, device=moving8.device)
    else:
        S11, mean_f, mean_m, _sum_w = rbc_point_moments(
            target, moving8, state.q, state.t, state.s,
            params.alpha, params.c, config.query_capacity,
            weighted=weighted, robust=robust,
            robust_delta=params.robust_delta,
            robust_adaptive=config.robust_adaptive)
        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m, mode=config.rotation.value,
            estimate_scale=config.estimate_scale)
    # Accumulate: R = R_k R;  t = s_k R_k t + t_k;  s = s_k s.
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)
