"""Sharded ICP over a (dp, mp) process mesh (port of
``icp_tpu.parallel.sharded``).

The moving (query) rows are sharded over ``dp`` and the RBC
representatives and their bins over ``mp``; every rank runs this module's
step on its share and every rank ends with the same state. Per iteration:

  * transform: local to the rank's dp rows.
  * phase-1 representative assignment: each mp rank scores its slice of the
    representatives for its dp rows (one float32 product and an argmin, as
    the JAX package computes it outside any kernel), then two ``pmin``s over
    mp (the distance, then the winner's id with the other ranks' set to a
    big sentinel) give the global nearest representative; ties go to the
    lowest representative id.
  * phase-2 search and reductions on the OWNER rank: it groups its queries
    into its local bins plus one parking bin for the queries other ranks
    own (K2 over n_r_local + 1 bins) and reduces in the grouped layout:
    K3 for POINT, K5's per-pair matches for PLANE, GICP and the
    robust-adaptive scale. Nothing is scattered back, and matched pairs
    never leave their owner.
  * one ``psum`` of the partial sums over the whole mesh: 18 floats for
    POINT, 27 (the 6x6 system and its right side) for PLANE / GICP; the
    robust-adaptive scale adds the two collectives of
    ``ops.moments.masked_median_sharded``.
  * the rotation solve: replicated, the same computation on every rank.

The loop is ``icp.run``'s chunked loop: a step whose loop condition is false
is computed but not taken (``torch.where``), and the host reads the loop
condition once per chunk. Every rank reads the same bits, so every rank
stops at the same chunk.

A query overflowing its bin's capacity, or owning an empty bin, is masked
out of that iteration's reductions, as in the single-device grouped paths.
"""

from __future__ import annotations

import dataclasses

import torch

from icp_tpu_torch.icp.gicp import gicp_system_partials
from icp_tpu_torch.icp.horn import solve_step_transform
from icp_tpu_torch.icp.plane import plane_system_partials, solve_plane_system
from icp_tpu_torch.icp.quaternion import qmul, qnormalize, qrotate, transform_points
from icp_tpu_torch.icp.run import CHUNK, _select, converged
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.kernels.fused_step import (
    assemble_point_moments,
    bin_point_moments,
    point_moment_partials,
    prep_similarity,
)
from icp_tpu_torch.ops.distance import metric_weights, pairwise_sq_dists
from icp_tpu_torch.ops.moments import (
    adaptive_robust_delta_sharded,
    centroid_partials,
    compute_weights,
    deviations,
    robust_factor,
    s_matrix,
)
from icp_tpu_torch.ops.normals import normals_for
from icp_tpu_torch.ops.sampling import sample_representative_indices
from icp_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS, Mesh, psum_pytree
from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct
from icp_tpu_torch.rbc.grouping import group_rows_by_bin
from icp_tpu_torch.rbc.search import bin_phase2
from icp_tpu_torch.runtime.config import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    Weighting,
)

_BIG_ID = 2 ** 30
_BOTH = (DP_AXIS, MP_AXIS)


def _slice_index_for_mp(index: RBCIndex, n_r_local: int, mesh: Mesh) -> RBCIndex:
    """This mp rank's slice of the representatives and bins of a replicated
    index. ``db`` stays whole: the fixed landmarks are far cheaper to copy
    than matched points are to move between ranks every iteration."""
    start = mesh.mp_index * n_r_local

    def sl(x):
        return None if x is None else x[start:start + n_r_local]

    return dataclasses.replace(
        index, reps=sl(index.reps), rep_db_ids=sl(index.rep_db_ids),
        bins=sl(index.bins), bin_ids=sl(index.bin_ids), bin_mask=sl(index.bin_mask),
        bins_centered=sl(index.bins_centered), sq_b_masked=sl(index.sq_b_masked),
        bin_normals=sl(index.bin_normals), moment_w=sl(index.moment_w),
        bins_vals12=sl(index.bins_vals12), gn_w=sl(index.gn_w))


def _phase1_owned_bins(local: RBCIndex, tm: torch.Tensor, params: ICPParams,
                       n_r_local: int, mesh: Mesh) -> torch.Tensor:
    """Global nearest representative by a min-with-payload combine.

    Returns (m_local,) int32 in [0, n_r_local]: the local bin of each query
    this rank owns, n_r_local (the parking bin) for queries other ranks
    own.
    """
    rep_offset = mesh.mp_index * n_r_local
    d2_qr = pairwise_sq_dists(tm, local.reps, params.alpha)
    best_local = torch.argmin(d2_qr, dim=1).to(torch.int32)
    d_local = torch.amin(d2_qr, dim=1)
    d_min = mesh.pmin(d_local, MP_AXIS)
    # The owner holds d_min bit for bit (a min returns one of its inputs);
    # ties across ranks go to the lowest representative id.
    rid = mesh.pmin(torch.where(d_local <= d_min, best_local + rep_offset,
                                torch.full_like(best_local, _BIG_ID)), MP_AXIS)
    local_rep = rid - rep_offset
    owned = (local_rep >= 0) & (local_rep < n_r_local)
    return torch.where(owned, local_rep, torch.full_like(local_rep, n_r_local))


def _point_partials(local: RBCIndex, moving_local: torch.Tensor,
                    state: ICPState, params: ICPParams, config: ICPConfig,
                    bin_of_query: torch.Tensor, n_r_local: int,
                    query_capacity: int) -> torch.Tensor:
    """This rank's POINT moment partials in the grouped layout: the owned
    RAW moving rows grouped into the local bins (K2; overflowing and
    remotely owned queries land in the parking bin, which is dropped), then
    K3's per-bin 8x8 moments, moved to the common frame. Returns the (18,)
    pre-mean sums; additive over ranks (each query counts on its owner
    only)."""
    glayout = group_rows_by_bin(bin_of_query, n_r_local + 1, query_capacity,
                                (moving_local,))
    mg = glayout.grouped[0][:n_r_local]
    qvalid = glayout.valid[:n_r_local].to(moving_local.dtype)
    G, b_row = prep_similarity(state.q, state.t, state.s)
    P_b = bin_point_moments(mg, qvalid, local.reps, local.bins_centered,
                            local.sq_b_masked, G.contiguous(), b_row, params.alpha,
                            weighted=config.weighting is Weighting.WEIGHTED,
                            robust=config.robust.value,
                            robust_delta=params.robust_delta)
    return point_moment_partials(P_b, local.reps, local.moment_w)


def _grouped_pairs(local: RBCIndex, tm: torch.Tensor, params: ICPParams,
                   config: ICPConfig, bin_of_query: torch.Tensor,
                   n_r_local: int, query_capacity: int,
                   extra_rows: torch.Tensor):
    """The owner rank's correspondence pairs (PLANE / GICP / adaptive
    robust): K2 groups the queries with their side rows, K5 searches each
    bin. Returns flat (n_r_local * cq, ...) tensors: (moving, matched fixed,
    nn distance, pair mask, matched fixed normals, side rows)."""
    glayout = group_rows_by_bin(bin_of_query, n_r_local + 1, query_capacity,
                                (tm, extra_rows))
    tg = glayout.grouped[0][:n_r_local]
    eg = glayout.grouped[1][:n_r_local]
    qvalid = glayout.valid[:n_r_local]

    qc = tg - local.reps[:, None, :]
    w8 = metric_weights(params.alpha, tm.dtype, tm.device)
    qg_w = qc * w8
    sq_q = torch.sum(qg_w * qc, dim=-1)
    best_score, matched_g, matched_n = bin_phase2(
        local.bins, local.bins_centered, local.sq_b_masked, local.bin_normals,
        qg_w, with_normals=config.needs_normals)
    best_d2 = torch.clamp(best_score + sq_q, min=0.0)
    valid = qvalid & torch.isfinite(best_score)

    n_rows = n_r_local * tg.shape[1]

    def flat(x):
        return x.reshape((n_rows,) + tuple(x.shape[2:]))

    return (flat(tg), flat(matched_g), flat(best_d2), flat(valid),
            flat(matched_n), flat(eg))


def sharded_icp_step(state: ICPState, moving_local: torch.Tensor,
                     index: RBCIndex, params: ICPParams, config: ICPConfig,
                     n_r_local: int, query_capacity: int, mesh: Mesh,
                     mnormals_local: torch.Tensor | None = None) -> ICPState:
    """One ICP iteration with this rank's dp rows and mp bins; every rank of
    ``mesh`` calls it with the same state and gets the same new state."""
    # The adaptive robust scale needs per-pair residuals for the median, so
    # POINT takes the grouped-pairs path then, as in the single-device step.
    adaptive = config.robust_adaptive and config.robust.value != "none"

    if config.correspondence is Correspondence.RBC:
        local = _slice_index_for_mp(index, n_r_local, mesh)
        tm = transform_points(moving_local, state.q, state.t, state.s)
        bin_of_query = _phase1_owned_bins(local, tm, params, n_r_local, mesh)

        if config.objective is Objective.POINT and not adaptive:
            # The fused grouped moments: one 18-float psum.
            sums = _point_partials(local, moving_local, state, params, config,
                                   bin_of_query, n_r_local, query_capacity)
            S11, mean_f, mean_m, _ = assemble_point_moments(
                mesh.psum(sums, _BOTH), params.c)
            qk, tk, sk = solve_step_transform(
                S11, mean_f, mean_m, mode=config.rotation.value,
                estimate_scale=config.estimate_scale)
            return _accumulate(state, qk, tk, sk)

        # The validity of each moving point rides in query lane 7, from its
        # ORIGINAL coordinates (a transformed invalid point sits at t, not 0).
        mv_valid = (torch.sum(torch.abs(moving_local[..., :3]), dim=-1) > 0
                    ).to(moving_local.dtype)
        tm = torch.cat([tm[:, :7], mv_valid[:, None]], dim=1)
        if ((config.objective is Objective.PLANE and config.plane_symmetric)
                or config.objective is Objective.GICP):
            extra_rows = qrotate(state.q, mnormals_local)
        else:
            extra_rows = tm.new_zeros((tm.shape[0], 0))
        mv, matched_f, nn_dist, mask, matched_n, extra = _grouped_pairs(
            local, tm, params, config, bin_of_query, n_r_local, query_capacity,
            extra_rows)
        mask = mask & (mv[..., 7] > 0.5) & (
            torch.sum(torch.abs(matched_f[..., :3]), dim=-1) > 0)
        mp_dup = 1  # each query is reduced on exactly one (dp, mp) rank
    else:
        # BRUTE: the full distance matrix against the replicated db; every
        # mp rank computes the same partials (divided out after the psum).
        tm = transform_points(moving_local, state.q, state.t, state.s)
        d2 = pairwise_sq_dists(tm, index.db, params.alpha)
        nn_id = torch.argmin(d2, dim=1)
        nn_dist = torch.amin(d2, dim=1)
        matched_f = index.db[nn_id]
        matched_n = (index.normals[nn_id] if config.needs_normals
                     else tm.new_zeros((tm.shape[0], 3)))
        extra = (qrotate(state.q, mnormals_local)
                 if config.objective is Objective.GICP
                 else tm.new_zeros((tm.shape[0], 0)))
        mv = tm
        mask = torch.logical_and(
            torch.sum(torch.abs(moving_local[..., :3]), dim=-1) > 0,
            torch.sum(torch.abs(matched_f[..., :3]), dim=-1) > 0)
        mp_dup = mesh.shape[MP_AXIS]

    robust = config.robust.value
    w = None
    if config.weighting is Weighting.WEIGHTED or robust != "none":
        w = (compute_weights(nn_dist) if config.weighting is Weighting.WEIGHTED
             else torch.ones_like(nn_dist))
        if robust != "none":
            delta = (adaptive_robust_delta_sharded(nn_dist, mask, robust, _BOTH, mesh)
                     if adaptive else params.robust_delta)
            w = w * robust_factor(nn_dist, robust, delta)

    if config.objective in (Objective.PLANE, Objective.GICP):
        # Per-rank 6x6 partials, one psum, the replicated solve.
        if config.objective is Objective.PLANE:
            if config.plane_symmetric:
                matched_n = matched_n + extra[..., :3]
            H, b = plane_system_partials(mv[..., :3], matched_f[..., :3],
                                         matched_n, w, mask)
        else:
            H, b = gicp_system_partials(mv[..., :3], matched_f[..., :3],
                                        matched_n, extra[..., :3],
                                        params.gicp_epsilon, w, mask)
        H, b = psum_pytree((H, b), _BOTH, mesh)
        qk, tk = solve_plane_system(H / mp_dup, b / mp_dup)
        sk = torch.ones((), dtype=tm.dtype, device=tm.device)
    else:
        # POINT through BRUTE or the grouped pairs (adaptive robust): the
        # centroid and S partials.
        sum_f, sum_m, denom = psum_pytree(centroid_partials(matched_f, mv, w, mask),
                                          _BOTH, mesh)
        mean_f = (sum_f / mp_dup) / (denom / mp_dup)
        mean_m = (sum_m / mp_dup) / (denom / mp_dup)
        S11 = mesh.psum(s_matrix(deviations(mv, mean_m), deviations(matched_f, mean_f),
                                 params.c, w, mask), _BOTH) / mp_dup
        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m, mode=config.rotation.value,
            estimate_scale=config.estimate_scale)
    return _accumulate(state, qk, tk, sk)


def _accumulate(state: ICPState, qk, tk, sk) -> ICPState:
    """The reference's accumulation: R = R_k R;  t = s_k R_k t + t_k;
    s = s_k s."""
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)


def sharded_icp_run(moving_local: torch.Tensor, index: RBCIndex,
                    params: ICPParams, config: ICPConfig, n_r_local: int,
                    query_capacity: int, mesh: Mesh,
                    mnormals_local: torch.Tensor | None = None) -> ICPState:
    """The convergence loop of :func:`sharded_icp_step`, in chunks of
    ``icp.run.CHUNK`` steps with one host read of the loop condition per
    chunk (the same on every rank)."""
    state = identity_state(moving_local.dtype, moving_local.device)
    done = torch.zeros((), dtype=torch.bool, device=moving_local.device)

    def running(s: ICPState, d: torch.Tensor) -> torch.Tensor:
        return torch.logical_and(s.k < config.max_iterations,
                                 torch.logical_or(s.k == 0, torch.logical_not(d)))

    while bool(running(state, done)):
        for _ in range(CHUNK):
            take = running(state, done)
            new = sharded_icp_step(state, moving_local, index, params, config,
                                   n_r_local, query_capacity, mesh,
                                   mnormals_local=mnormals_local)
            state = _select(take, new, state)
            done = torch.where(take, converged(new, params), done)
    return state


def sharded_query_capacity(config: ICPConfig, n_dp: int) -> int:
    """Per-bin query capacity on one dp rank.

    The rank's queries spread over the FULL representative range, so each
    local bin expects mu = (m / n_r) / n_dp of them. The single-device
    capacity scales by the same 1 / n_dp, but a pure multiplier
    under-provisions small means, where the occupancy's relative spread is
    larger, so it is floored at mu + 4 sqrt(mu) (~1e-4 tail under Poisson;
    an overflow drops the query for that iteration). 8-aligned; n_dp = 1
    gives the single-device capacity.
    """
    m_local = config.m // n_dp
    mu = max(m_local // config.n_r, 1)
    floor = mu + int(4 * mu ** 0.5)
    cap = max((config.query_capacity + n_dp - 1) // n_dp, floor)
    return max(((cap + 7) // 8) * 8, 8)


def make_sharded_register(mesh: Mesh, config: ICPConfig):
    """The multi-rank registration entry point.

    Every rank of ``mesh`` calls the returned ``run(fixed8, moving8, params)
    -> ICPState`` with the same full (m, 8) landmark sets: the fixed set is
    replicated, each rank keeps its dp slice of the moving set. Every rank
    returns the same state.
    """
    n_dp = mesh.shape[DP_AXIS]
    n_mp = mesh.shape[MP_AXIS]
    if config.n_r % n_mp != 0:
        raise ValueError("n_r must divide evenly over the mp axis")
    if config.m % n_dp != 0:
        raise ValueError("m must divide evenly over the dp axis")
    n_r_local = config.n_r // n_mp
    query_capacity = sharded_query_capacity(config, n_dp)

    def run(fixed8: torch.Tensor, moving8: torch.Tensor,
            params: ICPParams) -> ICPState:
        params = params.to(mesh.device)
        index, moving_local, mnormals_local = sharded_inputs(fixed8, moving8, params,
                                                             config, mesh)
        return sharded_icp_run(moving_local, index, params, config, n_r_local,
                               query_capacity, mesh, mnormals_local=mnormals_local)

    return run


def sharded_inputs(fixed8: torch.Tensor, moving8: torch.Tensor, params: ICPParams,
                   config: ICPConfig, mesh: Mesh):
    """This rank's inputs to :func:`sharded_icp_run`: the replicated index
    of the full fixed set, and its dp rows of the moving set and of their
    normals, on its device."""
    dev = mesh.device
    fixed8 = fixed8.to(dev).contiguous()
    moving8 = moving8.to(dev).contiguous()
    # The moving normals need the whole organized grid: computed before the
    # rows are split, and split with them. GICP only, as in the JAX package:
    # symmetric PLANE gets zeros here, so its sharded step constrains along
    # the fixed normals alone.
    if config.objective is Objective.GICP:
        mnormals = normals_for(moving8, config.normal_mode)
    else:
        mnormals = moving8.new_zeros((moving8.shape[0], 3))
    m_local = config.m // mesh.shape[DP_AXIS]
    lo = mesh.dp_index * m_local
    rep_ids = sample_representative_indices(fixed8.shape[0], config.n_r,
                                            config.rep_grid, device=dev)
    normals = normals_for(fixed8, config.normal_mode) if config.needs_normals else None
    index = rbc_construct(fixed8, fixed8[rep_ids.long()], params.alpha,
                          config.bin_capacity, rep_db_ids=rep_ids, normals=normals)
    return index, moving8[lo:lo + m_local], mnormals[lo:lo + m_local]
