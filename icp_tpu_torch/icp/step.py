"""One ICP iteration (port of the fused POINT branch of ``icp_tpu.icp.step``).

    transform + nearest rep (K1) -> grouping (sort + K2) -> per-bin search,
    weights and moments (K3) -> Horn inputs -> rotation solve -> accumulate

The tensors' device selects the path: CUDA tensors run the kernels, CPU
tensors their plain twins.
"""

from __future__ import annotations

from icp_tpu_torch.icp.horn import solve_step_transform
from icp_tpu_torch.icp.quaternion import qmul, qnormalize, qrotate
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.search import rbc_point_moments
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams, Weighting


def icp_step(state: ICPState, moving8, target: RBCIndex, params: ICPParams,
             config: ICPConfig) -> ICPState:
    """Run one ICP iteration and return the updated state.

    Args:
      state: accumulated transform state.
      moving8: (m, 8) ORIGINAL moving landmarks (the accumulated transform
        is re-applied from scratch each iteration).
      target: RBC index over the fixed landmarks.
      params: dynamic scalars.
      config: static configuration.
    """
    S11, mean_f, mean_m, _sum_w = rbc_point_moments(
        target, moving8, state.q, state.t, state.s,
        params.alpha, params.c, config.query_capacity,
        weighted=config.weighting is Weighting.WEIGHTED)
    qk, tk, sk = solve_step_transform(
        S11, mean_f, mean_m, mode=config.rotation.value,
        estimate_scale=config.estimate_scale)
    # Accumulate: R = R_k R;  t = s_k R_k t + t_k;  s = s_k s.
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)
