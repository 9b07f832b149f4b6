"""One ICP iteration (port of ``icp_tpu.icp.step``).

POINT, fused:  transform + nearest rep (K1) -> grouping (sort + K2) ->
               [K4: adaptive robust scale] -> per-bin search, weights and
               moments (K3) -> Horn inputs -> rotation solve -> accumulate
PLANE / GICP, fused: the same front half with K7 building the Gauss-Newton
               system as per-bin moments -> 6x6 solve (s_k = 1) -> accumulate
Unfused (``fused_point=False``, ``fused_gn=False`` or BRUTE): transform ->
               search (RBC: rep assignment, grouping, K5 in each bin; BRUTE:
               K6 over the whole set) -> per-pair weights -> centroids and
               S matrix + rotation solve (POINT), or the point-to-plane /
               GICP normal system + 6x6 solve -> accumulate

The tensors' device selects the path: CUDA tensors run the kernels, CPU
tensors their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.icp.gicp import solve_gicp
from icp_tpu_torch.icp.horn import solve_step_transform
from icp_tpu_torch.icp.plane import (
    CHARACTERISTIC_LENGTH_MM,
    solve_plane_system,
    solve_point_to_plane,
)
from icp_tpu_torch.icp.quaternion import qmul, qnormalize, qrotate, transform_points
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.kernels.fused_gn import gn_system_from_V
from icp_tpu_torch.ops.distance import nearest_neighbor_brute
from icp_tpu_torch.ops.moments import (
    adaptive_robust_delta,
    centroids,
    compute_weights,
    deviations,
    masked_weight_sum,
    robust_factor,
    s_matrix,
)
from icp_tpu_torch.ops.normals import normals_for
from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.search import (
    rbc_gn_system,
    rbc_point_moments,
    rbc_search_grouped,
)
from icp_tpu_torch.runtime.config import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    Weighting,
)


class BruteTarget(NamedTuple):
    """BRUTE target of the normal-consuming objectives: the fixed landmarks
    and their normals, without an RBC index."""

    db: torch.Tensor  # (n, 8) fixed landmarks
    normals: torch.Tensor  # (n, 3) fixed-surface normals


Target = RBCIndex | BruteTarget | torch.Tensor


def gn_mode(config: ICPConfig) -> str:
    """K7's mode for a normal-consuming objective."""
    if config.objective is Objective.GICP:
        return "gicp"
    return "plane_sym" if config.plane_symmetric else "plane"


def _find_correspondences(tm: torch.Tensor, target: Target, params: ICPParams,
                          config: ICPConfig,
                          extra_rows: torch.Tensor | None = None):
    """NN search of the unfused step: (moving (n, 8), matched fixed (n, 8),
    nn_dist (n,), mask (n,) or None, matched normals (n, 3), extra (n, k)).

    RBC returns every slot of the grouped layout (n = n_r * cq) with its
    validity mask: the reductions do not depend on the order, so nothing is
    scattered back. BRUTE returns the original order with mask None.
    """
    want_normals = config.needs_normals
    if config.correspondence is Correspondence.RBC:
        if not isinstance(target, RBCIndex):
            raise TypeError("RBC correspondence needs an RBCIndex target")
        res = rbc_search_grouped(target, tm, params.alpha, config.query_capacity,
                                 with_normals=want_normals, extra_rows=extra_rows)
        n_rows = res.queries_g.shape[0] * res.queries_g.shape[1]

        def flat(x):
            return x.reshape((n_rows,) + tuple(x.shape[2:]))

        return (flat(res.queries_g), flat(res.matched_g), flat(res.dist_g),
                flat(res.valid), flat(res.matched_normals), flat(res.extra_g))
    db = target.db if isinstance(target, BruteTarget) else target
    nn_idx, nn_dist = nearest_neighbor_brute(tm, db, params.alpha)
    nn = nn_idx.long()
    if want_normals:
        if not isinstance(target, BruteTarget):
            raise TypeError("BRUTE with a normal-consuming objective needs a "
                            "BruteTarget carrying the fixed normals")
        nrm = target.normals[nn]
    else:
        nrm = tm.new_zeros((tm.shape[0], 3))
    extra = extra_rows if extra_rows is not None else tm.new_zeros((tm.shape[0], 0))
    return tm, db[nn], nn_dist, None, nrm, extra


def _unfused_increment(state: ICPState, moving8: torch.Tensor, target: Target,
                       params: ICPParams, config: ICPConfig,
                       moving_normals: torch.Tensor | None):
    """(qk, tk, sk) of the per-pair pipeline: search, weights, then the
    objective's solve."""
    # The transformed set carries the validity of each ORIGINAL moving
    # point in query lane 7 (metric weight 0): a zero-depth point moved by
    # the accumulated transform sits at t, not 0.
    tm = transform_points(moving8, state.q, state.t, state.s)
    mv_valid = (torch.sum(torch.abs(moving8[..., :3]), dim=-1) > 0).to(moving8.dtype)
    tm = torch.cat([tm[:, :7], mv_valid[:, None]], dim=1)

    extra_rows = None
    if config.needs_normals and gn_mode(config) != "plane":
        if moving_normals is None:
            moving_normals = normals_for(moving8, config.normal_mode)
        extra_rows = qrotate(state.q, moving_normals)
    mv, matched_f, nn_dist, mask, matched_n, extra = _find_correspondences(
        tm, target, params, config, extra_rows=extra_rows)

    # Drop pairs with a zero-geometry point on either side: the moving side
    # from lane 7, the fixed side (untransformed) from its coordinates.
    pair_valid = torch.logical_and(
        mv[..., 7] > 0.5, torch.sum(torch.abs(matched_f[..., :3]), dim=-1) > 0)
    mask = pair_valid if mask is None else torch.logical_and(mask, pair_valid)

    robust = config.robust.value
    weighted = config.weighting is Weighting.WEIGHTED
    w, sum_w = None, None
    if weighted or robust != "none":
        w = compute_weights(nn_dist) if weighted else torch.ones_like(nn_dist)
        if robust != "none":
            delta = (adaptive_robust_delta(nn_dist, mask, robust)
                     if config.robust_adaptive else params.robust_delta)
            w = w * robust_factor(nn_dist, robust, delta)
        w = torch.where(mask, w, torch.zeros_like(w))
        sum_w = masked_weight_sum(w)

    one = torch.ones((), dtype=mv.dtype, device=mv.device)
    if config.objective is Objective.PLANE:
        if config.plane_symmetric:
            # Constrain along the summed fixed + moving normal.
            matched_n = matched_n + extra[..., :3]
        qk, tk = solve_point_to_plane(mv[..., :3], matched_f[..., :3],
                                      matched_n, w, mask)
        return qk, tk, one
    if config.objective is Objective.GICP:
        qk, tk = solve_gicp(mv[..., :3], matched_f[..., :3], matched_n,
                            extra[..., :3], params.gicp_epsilon, w, mask)
        return qk, tk, one
    mean_f, mean_m = centroids(matched_f, mv, w, sum_w, mask)
    S11 = s_matrix(deviations(mv, mean_m), deviations(matched_f, mean_f),
                   params.c, w, mask)
    return solve_step_transform(S11, mean_f, mean_m, mode=config.rotation.value,
                                estimate_scale=config.estimate_scale)


def icp_step(state: ICPState, moving8, target: Target, params: ICPParams,
             config: ICPConfig,
             moving_normals: torch.Tensor | None = None) -> ICPState:
    """Run one ICP iteration and return the updated state.

    Args:
      state: accumulated transform state.
      moving8: (m, 8) ORIGINAL moving landmarks (the accumulated transform
        is re-applied from scratch each iteration).
      target: an RBCIndex over the fixed landmarks (RBC; built with normals
        for PLANE / GICP), a :class:`BruteTarget` (BRUTE with PLANE /
        GICP) or the (n, 8) fixed landmarks (BRUTE POINT).
      params: dynamic scalars.
      config: static configuration.
      moving_normals: optional (m, 3) moving-cloud normals for the symmetric
        PLANE and GICP objectives; ``icp_run`` computes them once, None
        computes them here.
    """
    weighted = config.weighting is Weighting.WEIGHTED
    robust = config.robust.value
    rbc = config.correspondence is Correspondence.RBC
    if rbc and config.needs_normals and config.fused_gn:
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
    elif rbc and config.objective is Objective.POINT and config.fused_point:
        S11, mean_f, mean_m, _sum_w = rbc_point_moments(
            target, moving8, state.q, state.t, state.s,
            params.alpha, params.c, config.query_capacity,
            weighted=weighted, robust=robust,
            robust_delta=params.robust_delta,
            robust_adaptive=config.robust_adaptive)
        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m, mode=config.rotation.value,
            estimate_scale=config.estimate_scale)
    else:
        qk, tk, sk = _unfused_increment(state, moving8, target, params, config,
                                        moving_normals)
    return accumulate(state, qk, tk, sk)


def accumulate(state: ICPState, qk, tk, sk) -> ICPState:
    """The reference's accumulation of a step's increment (qk, tk, sk):
    R = R_k R;  t = s_k R_k t + t_k;  s = s_k s."""
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)
