"""Iterate-to-convergence loop (port of ``icp_tpu.icp.run``).

The JAX package runs the loop as one ``lax.while_loop``: at least one step,
then steps until ``max_iterations`` or until the new state passes
:func:`converged`. Here the steps run in fixed chunks of
:data:`CHUNK` with no host synchronization inside a chunk: a step whose
loop condition is false is computed but not taken (``torch.where`` keeps
the old state and ``k`` stops counting), and the host reads the loop
condition once per chunk. The final state and ``k`` equal those of the
step-by-step loop. With ``reads=False`` the host reads nothing: every chunk
that ``max_iterations`` allows runs, and the steps past the stop are frozen,
so the state is the same bit for bit (the odometry chain enqueues a whole
sequence that way). :func:`register_batch` runs the same loop over the
lanes of a batch of pairs.

On CUDA tensors a chunk is one CUDA graph (``icp/chunk_graph.py``),
captured the first time a configuration, number of lanes and set of
tensor shapes is seen and replayed after that, but for the step paths of
:data:`EAGER_ROTATIONS`; CPU tensors run the chunk eagerly. Both run one
function, :func:`_chunk`, and give the same bits.

Spans (``runtime/timing.py``, recorded while switched on): ``icp.register``
around each :func:`register` and :func:`register_batch` (a registration
id), ``icp.build_target`` (and ``icp.normals`` inside it, from
``ops/normals.py``), ``icp.run`` around the loop, ``icp.moving_normals``
in it around each estimate of a moving set's normals (symmetric PLANE and
GICP; its own ``icp.normals`` inside), ``icp.chunk``
around the enqueue (or the replay) of each chunk over all lanes and
``icp.host_read`` around each read of the loop condition. Counters
(always): ``icp.steps_enqueued`` (one a lane a step computed, taken or
not), ``icp.moving_normals`` (one a moving set's normals estimated),
``icp.chunk_eager`` (a chunk enqueued from Python),
``icp.chunk_graph.replays`` and ``icp.chunk_graph.captures``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from icp_tpu_torch.icp import chunk_graph
from icp_tpu_torch.icp.quaternion import qangle_deg
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.icp.step import BruteTarget, Target, gn_mode, icp_step
from icp_tpu_torch.ops.normals import normals_for
from icp_tpu_torch.ops.sampling import sample_representative_indices
from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct
from icp_tpu_torch.runtime.config import (Correspondence, ICPConfig, ICPParams, Objective,
                                          RotationMode)
from icp_tpu_torch.runtime.timing import count, span

CHUNK = 8  # steps between host reads of the loop condition
# POINT steps that solve the rotation with these check the LAPACK status of
# torch.linalg.svd / torch.linalg.eigh on the host, a read that a CUDA
# graph's capture forbids: their chunks run eagerly.
EAGER_ROTATIONS = frozenset({RotationMode.SVD, RotationMode.JACOBI})


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


class _Inputs(NamedTuple):
    """What the loop reads and never writes, one entry a lane."""

    movings: list
    targets: list
    params: ICPParams
    mnormals: list  # the moving normals, or None where the step needs none


class _Carry(NamedTuple):
    """What a chunk advances."""

    states: list
    dones: list  # 0-d bool: the lane's last step taken passed converged()
    running: torch.Tensor  # 0-d bool: some lane's loop condition holds


def _running(state: ICPState, done: torch.Tensor, config: ICPConfig) -> torch.Tensor:
    return torch.logical_and(state.k < config.max_iterations,
                             torch.logical_or(state.k == 0, torch.logical_not(done)))


def _carry(states: list, dones: list, config: ICPConfig) -> _Carry:
    return _Carry(states, dones, torch.stack(
        [_running(s, d, config) for s, d in zip(states, dones)]).any())


def _any_running(carry: _Carry) -> bool:
    """The host's read of the loop condition."""
    with span("icp.host_read"):
        return bool(carry.running)


def _chunk(inputs: _Inputs, carry: _Carry, config: ICPConfig) -> _Carry:
    """CHUNK steps over every lane: a lane whose loop condition is false is
    frozen by ``torch.where``; no host read. The eager loop and the CUDA
    graph run this same function."""
    states, dones = list(carry.states), list(carry.dones)
    for _ in range(CHUNK):
        for i, (moving8, target, mnormals) in enumerate(
                zip(inputs.movings, inputs.targets, inputs.mnormals)):
            take = _running(states[i], dones[i], config)
            new = icp_step(states[i], moving8, target, inputs.params, config,
                           moving_normals=mnormals)
            states[i] = _select(take, new, states[i])
            dones[i] = torch.where(take, converged(new, inputs.params), dones[i])
    return _carry(states, dones, config)


def chunk_captured(device: torch.device, config: ICPConfig) -> bool:
    """Whether :func:`_run_lanes` replays its chunks as a CUDA graph: on
    CUDA tensors, but for the step paths of :data:`EAGER_ROTATIONS`."""
    return device.type == "cuda" and not (config.objective is Objective.POINT
                                          and config.rotation in EAGER_ROTATIONS)


def chunk_key(inputs: _Inputs, carry: _Carry, config: ICPConfig) -> tuple:
    """The graph cache's key: the device, the configuration and the
    signature (``chunk_graph.signature``) of the inputs and the carry, which
    holds the number of lanes and every tensor's shape, strides and dtype."""
    return (carry.running.device, config, chunk_graph.signature(inputs),
            chunk_graph.signature(carry))


def _moving_normals(moving8: torch.Tensor, config: ICPConfig) -> torch.Tensor:
    """The moving set's normals, in the span and counter that tell them
    apart from the fixed set's."""
    with span("icp.moving_normals"):
        count("icp.moving_normals")
        return normals_for(moving8, config.normal_mode)


def _run_lanes(movings: list, targets: list, params: ICPParams,
               config: ICPConfig, inits: list, reads: bool = True) -> list:
    """The loop of :func:`icp_run` over independent lanes (pairs): each lane
    keeps its own state and done flag, and a lane whose loop condition is
    false is frozen by ``torch.where`` while the others step. The host reads
    once per chunk whether any lane still runs (with ``reads=False``, never:
    all ``ceil(max_iterations / CHUNK)`` chunks run), so each lane ends with
    the state and ``k`` that :func:`icp_run` gives its pair alone. Where
    :func:`chunk_captured`, each chunk is a replay of one CUDA graph, bitwise
    the eager chunk."""
    dev = movings[0].device
    with span("icp.run"):
        # The moving normals (symmetric PLANE / GICP) are loop-invariant: once
        # per registration, not once per step.
        mnormals = [_moving_normals(m, config)
                    if config.needs_normals and gn_mode(config) != "plane" else None
                    for m in movings]
        inputs = _Inputs(movings, targets, params, mnormals)
        carry = _carry(list(inits), [torch.zeros((), dtype=torch.bool, device=dev)
                                     for _ in movings], config)
        body = functools.partial(_chunk, config=config)
        graph = None
        if chunk_captured(dev, config):
            graph = chunk_graph.chunk_graph(chunk_key(inputs, carry, config), body,
                                            inputs, carry)
            carry = graph.carry  # replays advance it in place
        chunks = -(-config.max_iterations // CHUNK)
        while (_any_running(carry) if reads else chunks > 0):
            chunks -= 1
            count("icp.steps_enqueued", CHUNK * len(movings))
            with span("icp.chunk"):
                if graph is None:
                    carry = body(inputs, carry)
                    count("icp.chunk_eager")
                else:
                    graph.replay()
        return list(carry.states) if graph is None else graph.take().states


def icp_run(moving8: torch.Tensor, target: Target, params: ICPParams,
            config: ICPConfig, init: ICPState | None = None,
            reads: bool = True) -> ICPState:
    """Run ICP to convergence: at least one iteration; stop after
    ``max_iterations`` in total or when the last increment is below both
    thresholds. ``target`` is what :func:`build_target` returns for
    ``config``. ``reads=False`` enqueues the loop with no host read and
    gives the same state."""
    dev = moving8.device
    state = identity_state(moving8.dtype, dev) if init is None else init
    return _run_lanes([moving8], [target], params.to(dev), config, [state],
                      reads=reads)[0]


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
    with span("icp.build_target"):
        if config.correspondence is Correspondence.RBC:
            return build_index(fixed8, params, config)
        if config.needs_normals:
            return BruteTarget(db=fixed8, normals=normals_for(fixed8, config.normal_mode))
        return fixed8


def _check_landmarks(fixed8: torch.Tensor, moving8: torch.Tensor, batched: bool) -> None:
    """Both sets (m, 8), or (B, m, 8) with one B, float32 on one device."""
    if fixed8.device != moving8.device:
        raise ValueError(f"fixed8 on {fixed8.device}, moving8 on {moving8.device}")
    shape, ndim = ("(B, m, 8)", 3) if batched else ("(m, 8)", 2)
    for name, x in (("fixed8", fixed8), ("moving8", moving8)):
        if x.dtype != torch.float32 or x.dim() != ndim or x.shape[-1] != 8:
            raise ValueError(f"{name}: expected {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if fixed8.shape[:-2] != moving8.shape[:-2]:
        raise ValueError(f"batch sizes differ: {fixed8.shape[0]} and {moving8.shape[0]}")


def register(fixed8: torch.Tensor, moving8: torch.Tensor,
             params: ICPParams, config: ICPConfig) -> ICPState:
    """Full registration: build the search target over the fixed landmarks
    (:func:`build_target`), run ICP to convergence and return the
    accumulated transform.

    Args:
      fixed8, moving8: (m, 8) float32 landmarks on one device.
    """
    _check_landmarks(fixed8, moving8, batched=False)
    with span("icp.register", registration=True):
        fixed8, moving8 = fixed8.contiguous(), moving8.contiguous()
        params = params.to(fixed8.device)
        return icp_run(moving8, build_target(fixed8, params, config), params, config)


def register_batch(fixed8: torch.Tensor, moving8: torch.Tensor,
                   params: ICPParams, config: ICPConfig) -> ICPState:
    """Register a batch of pairs (the JAX package's ``vmap`` of
    :func:`register`): one search target per pair, then one chunked loop
    over all pairs, each pair a lane with its own state, frozen once its
    loop condition is false, and one host read per chunk for the whole
    batch. Each lane's step launches that lane's kernels, so each lane's
    result, ``k`` included, is :func:`register` of its pair.

    Args:
      fixed8, moving8: (B, m, 8) float32 landmark sets on one device.
      params, config: shared by the batch.
    Returns:
      an ICPState with a leading batch axis on every field.
    """
    _check_landmarks(fixed8, moving8, batched=True)
    if fixed8.shape[0] == 0:
        raise ValueError("register_batch needs at least one pair")
    dev = fixed8.device
    with span("icp.register", registration=True):
        params = params.to(dev)
        fixed = [f.contiguous() for f in fixed8]
        movings = [m.contiguous() for m in moving8]
        targets = [build_target(f, params, config) for f in fixed]
        states = _run_lanes(movings, targets, params, config,
                            [identity_state(moving8.dtype, dev) for _ in movings])
        return ICPState(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                           for f in dataclasses.fields(ICPState)})
