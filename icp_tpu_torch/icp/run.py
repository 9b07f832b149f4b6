"""Iterate-to-convergence loop (port of ``icp_tpu.icp.run``).

The JAX package runs the loop as one ``lax.while_loop``: at least one step,
then steps until ``max_iterations`` or until the new state passes
:func:`converged`. Here the steps run in fixed chunks of
:data:`CHUNK` with no host synchronization inside a chunk: a step whose
loop condition is false is computed but not taken (``torch.where`` keeps
the old state and ``k`` stops counting), and the host reads the loop
condition once per chunk. The final state and ``k`` equal those of the
step-by-step loop.
"""

from __future__ import annotations

import dataclasses

import torch

from icp_tpu_torch.icp.quaternion import qangle_deg
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.icp.step import BruteTarget, Target, gn_mode, icp_step
from icp_tpu_torch.ops.normals import normals_for
from icp_tpu_torch.ops.sampling import sample_representative_indices
from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct
from icp_tpu_torch.runtime.config import Correspondence, ICPConfig, ICPParams

CHUNK = 8  # steps between host reads of the loop condition


def converged(state: ICPState, params: ICPParams) -> torch.Tensor:
    """Reference ``ICP::check``: the incremental rotation angle (degrees)
    and translation norm are both below their thresholds."""
    delta_angle = qangle_deg(state.qk)
    delta_t = torch.linalg.vector_norm(state.tk)
    return torch.logical_and(delta_angle < params.angle_threshold_deg,
                             delta_t < params.translation_threshold)


def _select(take: torch.Tensor, new: ICPState, old: ICPState) -> ICPState:
    return ICPState(**{
        f.name: torch.where(take, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(ICPState)})


def icp_run(moving8: torch.Tensor, target: Target, params: ICPParams,
            config: ICPConfig, init: ICPState | None = None) -> ICPState:
    """Run ICP to convergence: at least one iteration; stop after
    ``max_iterations`` in total or when the last increment is below both
    thresholds. ``target`` is what :func:`build_target` returns for
    ``config``."""
    dev = moving8.device
    params = params.to(dev)
    state = identity_state(moving8.dtype, dev) if init is None else init
    done = torch.zeros((), dtype=torch.bool, device=dev)
    # The moving normals (symmetric PLANE / GICP) are loop-invariant: once
    # per registration, not once per step.
    mnormals = None
    if config.needs_normals and gn_mode(config) != "plane":
        mnormals = normals_for(moving8, config.normal_mode)

    def running(s: ICPState, done: torch.Tensor) -> torch.Tensor:
        return torch.logical_and(s.k < config.max_iterations,
                                 torch.logical_or(s.k == 0,
                                                  torch.logical_not(done)))

    while bool(running(state, done)):  # one host read per chunk
        for _ in range(CHUNK):
            take = running(state, done)
            new = icp_step(state, moving8, target, params, config,
                           moving_normals=mnormals)
            state = _select(take, new, state)
            done = torch.where(take, converged(new, params), done)
    return state


def build_index(fixed8: torch.Tensor, params: ICPParams,
                config: ICPConfig) -> RBCIndex:
    """Representative sampling + RBC construction over the fixed landmarks,
    with their normals when the objective needs them."""
    rep_ids = sample_representative_indices(fixed8.shape[0], config.n_r,
                                            config.rep_grid,
                                            device=fixed8.device)
    reps = fixed8[rep_ids.long()]
    normals = (normals_for(fixed8, config.normal_mode)
               if config.needs_normals else None)
    return rbc_construct(fixed8, reps, params.alpha, config.bin_capacity,
                         rep_db_ids=rep_ids, normals=normals)


def build_target(fixed8: torch.Tensor, params: ICPParams,
                 config: ICPConfig) -> Target:
    """The search target of ``config``: an RBC index (RBC), the fixed
    landmarks with their normals (BRUTE with PLANE / GICP), or the bare
    fixed landmarks (BRUTE POINT)."""
    if config.correspondence is Correspondence.RBC:
        return build_index(fixed8, params, config)
    if config.needs_normals:
        return BruteTarget(db=fixed8, normals=normals_for(fixed8, config.normal_mode))
    return fixed8


def register(fixed8: torch.Tensor, moving8: torch.Tensor,
             params: ICPParams, config: ICPConfig) -> ICPState:
    """Full registration: build the search target over the fixed landmarks
    (:func:`build_target`), run ICP to convergence and return the
    accumulated transform.

    Args:
      fixed8, moving8: (m, 8) float32 landmarks on one device.
    """
    if fixed8.device != moving8.device:
        raise ValueError(f"fixed8 on {fixed8.device}, moving8 on {moving8.device}")
    for name, x in (("fixed8", fixed8), ("moving8", moving8)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 8:
            raise ValueError(f"{name}: expected (m, 8) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    fixed8, moving8 = fixed8.contiguous(), moving8.contiguous()
    params = params.to(fixed8.device)
    return icp_run(moving8, build_target(fixed8, params, config), params, config)
