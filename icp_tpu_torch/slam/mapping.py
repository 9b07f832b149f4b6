"""Keyframe mapping engine: odometry, loop closure and the pose-graph
backend (port of ``icp_tpu.slam.mapping``).

The engine consumes frames, chains ICP odometry, promotes keyframes,
detects loop closures by pose proximity, verifies all of a keyframe's
candidates in one batched registration, and refines the trajectory with
the pose-graph optimizer. Everything runs on the device of the frames it
is fed; the loop-closure gating runs on host-side numpy mirrors of the
keyframe poses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from icp_tpu_torch.icp.pyramid import register_pyramid
from icp_tpu_torch.icp.quaternion import qangle_deg
from icp_tpu_torch.icp.run import register, register_batch
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.parallel.resilience import with_retries
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams
from icp_tpu_torch.slam import se3
from icp_tpu_torch.slam.odometry import KeyframePolicy, frame_to_landmarks
from icp_tpu_torch.slam.pose_graph import (PoseGraph, graph_from_poses, optimize,
                                           optimize_pcg, pad_edges, pad_nodes)


@dataclass
class Keyframe:
    """A map node: pose estimate and its landmark cloud."""

    index: int  # frame index it came from
    pose: se3.Pose  # world_from_camera estimate
    landmarks: torch.Tensor  # (m, 8) camera-frame landmarks


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure candidate gating and acceptance.

    A keyframe pair is a candidate when their estimated poses are within
    ``max_distance`` translation and ``max_angle_deg`` rotation but at least
    ``min_gap`` keyframes apart; the candidate is verified by a full ICP
    registration and accepted when ICP converges within
    ``max_iterations_accept`` iterations (non-convergent registrations are
    unreliable matches).
    """

    max_distance: float = 300.0  # mm
    max_angle_deg: float = 15.0
    min_gap: int = 3
    max_iterations_accept: int = 39
    # Pad every verification batch UP to this size (still rounded up to a
    # power of two above it). 0 keeps pure power-of-two padding. One fixed
    # batch size gives the session one shape of verification batch; the
    # padded lanes repeat a real candidate.
    verify_pad_to: int = 0


@dataclass
class SlamMap:
    """The map: keyframes and pose-graph edges."""

    keyframes: List[Keyframe] = field(default_factory=list)
    edges: List[Tuple[int, int]] = field(default_factory=list)  # kf indices
    measurements: List[se3.Pose] = field(default_factory=list)
    weights: List[float] = field(default_factory=list)
    loop_closures: List[Tuple[int, int]] = field(default_factory=list)


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stack_states(states: List[ICPState]) -> ICPState:
    return ICPState(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                       for f in dataclasses.fields(ICPState)})


class SlamEngine:
    """Frame-in, trajectory-out SLAM engine."""

    def __init__(self, params: Optional[ICPParams] = None,
                 config: Optional[ICPConfig] = None,
                 policy: KeyframePolicy = KeyframePolicy(),
                 loop_config: LoopClosureConfig = LoopClosureConfig(),
                 use_pyramid: bool = False,
                 pyramid_strides: tuple = (4, 2, 1),
                 dispatch_retries: int = 0,
                 incremental_optimize: bool = False,
                 incremental_iterations: int = 3):
        """Args of note:
          incremental_optimize: iSAM-style incremental smoothing: run
            ``incremental_iterations`` warm-started iterations of the
            pose-graph backend right after every accepted loop closure,
            instead of deferring all correction to a final
            ``optimize_map``. Graph shapes are padded (nodes to powers of
            two, edges to multiples of 64).
          use_pyramid: run frame-to-frame registrations coarse to fine
            (``icp.pyramid``): a wider basin for fast motion, at ~1.3x the
            per-frame cost. Loop-closure verification uses the pyramid too
            when enabled (closure candidates have the largest pose error).
          dispatch_retries: bounded retries (``parallel.resilience``)
            around each PURE registration dispatch. Retrying here is safe;
            wrapping ``process_frame`` from outside is NOT (it mutates the
            engine's state before its last dispatch, so an outer retry
            would duplicate the frame).
        """
        self.params = params or ICPParams(alpha=2e2)
        # Rigid mode: scale drift compounds over a trajectory.
        self.config = config or ICPConfig(estimate_scale=False)
        self.policy = policy
        self.loop_config = loop_config
        self.use_pyramid = use_pyramid
        self.pyramid_strides = pyramid_strides
        self.dispatch_retries = dispatch_retries
        self.incremental_optimize = incremental_optimize
        self.incremental_iterations = incremental_iterations
        self.n_incremental_updates = 0  # diagnostic
        self.map = SlamMap()
        self.trajectory: List[se3.Pose] = []
        self._prev_lms: Optional[torch.Tensor] = None
        self._gap_since_kf = 0
        # Loop-closure scaling state: a grid hash over keyframe positions
        # (cell = max_distance, so every in-range candidate lives in the
        # 3^3 neighborhood), host-side numpy pose mirrors so the gating
        # reads nothing from the device, and the verification dispatch of
        # each padded batch size the session used.
        self._kf_grid: dict = {}
        self._kf_pos: List[np.ndarray] = []
        self._kf_quat: List[np.ndarray] = []
        self._verify_fns: dict = {}
        self.n_pairs_verified = 0  # diagnostic: total closure registrations

    def _dispatch(self, fn, *args):
        if self.dispatch_retries > 0:
            return with_retries(fn, *args, retries=self.dispatch_retries)
        return fn(*args)

    def _register_one(self, fixed_lms, moving_lms) -> ICPState:
        if self.use_pyramid:
            return register_pyramid(fixed_lms, moving_lms, self.params, self.config,
                                    self.pyramid_strides)
        return register(fixed_lms, moving_lms, self.params, self.config)

    # -- frame ingestion ----------------------------------------------------

    def process_frame(self, cloud8) -> se3.Pose:
        """Ingest one camera-frame cloud ((480, 640, 8), (307200, 8) or
        (m, 8) landmarks; a numpy array goes to the card); returns the
        world pose estimate."""
        if not isinstance(cloud8, torch.Tensor):
            cloud8 = torch.as_tensor(cloud8, device="cuda")
        lms = frame_to_landmarks(cloud8) if cloud8.ndim != 2 or \
            cloud8.shape[0] != self.config.m else cloud8

        if self._prev_lms is None:
            pose = se3.Pose.identity(lms.dtype, lms.device)
            self.trajectory.append(pose)
            self._add_keyframe(0, pose, lms, se3.Pose(np.array([0.0, 0.0, 0.0, 1.0], np.float32),
                                                      np.zeros(3, np.float32)))
            self._prev_lms = lms
            return pose

        state = self._dispatch(self._register_one, self._prev_lms, lms)
        rel = se3.Pose(state.q, state.t)  # prev_from_cur
        pose = se3.compose(self.trajectory[-1], rel)
        self.trajectory.append(pose)
        self._prev_lms = lms

        frame_idx = len(self.trajectory) - 1
        self._gap_since_kf += 1
        last_kf = self.map.keyframes[-1]
        d = se3.relative(last_kf.pose, pose)
        # The frame's one host read: the motion since the last keyframe and
        # the pose (the grid's mirror, if this frame becomes a keyframe).
        host = torch.cat([d.q, d.t, pose.q, pose.t]).cpu()
        if (float(qangle_deg(host[:4])) > self.policy.max_angle_deg
                or float(torch.linalg.vector_norm(host[4:7])) > self.policy.max_translation
                or self._gap_since_kf >= self.policy.max_gap):
            self._add_keyframe(frame_idx, pose, lms,
                               se3.Pose(host[7:11].numpy(), host[11:14].numpy()))
        return pose

    def _add_keyframe(self, frame_idx: int, pose: se3.Pose, lms: torch.Tensor,
                      pose_host: se3.Pose) -> None:
        kf_idx = len(self.map.keyframes)
        self.map.keyframes.append(Keyframe(frame_idx, pose, lms))
        self._gap_since_kf = 0
        if kf_idx > 0:
            prev = self.map.keyframes[kf_idx - 1]
            self.map.edges.append((kf_idx - 1, kf_idx))
            self.map.measurements.append(se3.relative(prev.pose, pose))
            self.map.weights.append(1.0)
        self._detect_loop_closures(kf_idx, pose_host)
        self._grid_insert(kf_idx, pose_host)

    # -- loop closure -------------------------------------------------------
    #
    # A grid hash over positions bounds the candidate set to the spatial
    # neighborhood, the pose gates run vectorized on host-side numpy
    # mirrors (no device traffic), and all surviving candidates of a
    # keyframe verify in ONE batched registration (the batch padded to a
    # power of two).

    def _cell(self, t: np.ndarray) -> tuple:
        cs = self.loop_config.max_distance
        return (int(np.floor(t[0] / cs)), int(np.floor(t[1] / cs)),
                int(np.floor(t[2] / cs)))

    def _grid_insert(self, kf_idx: int, pose: se3.Pose) -> None:
        t = _np(pose.t)
        self._kf_pos.append(t)
        self._kf_quat.append(_np(pose.q))
        self._kf_grid.setdefault(self._cell(t), []).append(kf_idx)

    def _rebuild_grid(self) -> None:
        """Re-key the spatial index after poses move (optimize_map), from
        one read of the keyframe poses."""
        self._kf_grid.clear()
        kfs = self.map.keyframes
        qs = _np(torch.stack([kf.pose.q for kf in kfs])) if kfs else np.zeros((0, 4))
        ts = _np(torch.stack([kf.pose.t for kf in kfs])) if kfs else np.zeros((0, 3))
        self._kf_pos = list(ts)
        self._kf_quat = list(qs)
        for i, t in enumerate(self._kf_pos):
            self._kf_grid.setdefault(self._cell(t), []).append(i)

    def _candidate_ids(self, kf_idx: int, pose: se3.Pose) -> List[int]:
        """Spatially plausible, gap-separated, pose-gated candidates."""
        lc = self.loop_config
        t_cur = _np(pose.t)
        q_cur = _np(pose.q)
        cx, cy, cz = self._cell(t_cur)
        ids: List[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    ids.extend(self._kf_grid.get((cx + dx, cy + dy, cz + dz), ()))
        ids = sorted(j for j in set(ids) if j < kf_idx - lc.min_gap)
        if not ids:
            return []
        ts = np.stack([self._kf_pos[j] for j in ids])
        qs = np.stack([self._kf_quat[j] for j in ids])
        dist = np.linalg.norm(ts - t_cur, axis=1)  # |R_a^T (t_b - t_a)|
        dots = np.clip(np.abs(qs @ q_cur), 0.0, 1.0)
        ang = np.degrees(2.0 * np.arccos(dots))
        keep = (dist <= lc.max_distance) & (ang <= lc.max_angle_deg)
        return [j for j, k in zip(ids, keep) if k]

    def _verify_batch(self, fixed_stack: torch.Tensor, moving_lms: torch.Tensor) -> ICPState:
        """One batched registration of every fixed set against the moving
        set: ``register_batch`` (each lane is ``register`` of its pair), or
        with the pyramid ``register_pyramid`` of each lane in turn."""
        b = fixed_stack.shape[0]
        if b not in self._verify_fns:
            if self.use_pyramid:
                def fn(f, m):
                    return _stack_states([self._register_one(f[i], m) for i in range(b)])
            else:
                def fn(f, m):
                    return register_batch(f, m.expand(b, -1, -1), self.params, self.config)
            self._verify_fns[b] = fn
        return self._dispatch(self._verify_fns[b], fixed_stack, moving_lms)

    def _detect_loop_closures(self, kf_idx: int, pose_host: se3.Pose) -> None:
        cur = self.map.keyframes[kf_idx]
        lc = self.loop_config
        cand = self._candidate_ids(kf_idx, pose_host)
        if not cand:
            return
        # Pad to the next power of two (at most log2(K) batch shapes);
        # padding lanes repeat the last candidate. verify_pad_to >= batch
        # collapses that to one shape.
        b = max(1 << (len(cand) - 1).bit_length(), lc.verify_pad_to)
        padded = cand + [cand[-1]] * (b - len(cand))
        fixed_stack = torch.stack([self.map.keyframes[j].landmarks for j in padded])
        states = self._verify_batch(fixed_stack, cur.landmarks)
        self.n_pairs_verified += len(cand)
        ks = _np(states.k)
        accepted = 0
        for i, j in enumerate(cand):
            # Accept when ICP converged within the budget (non-convergent
            # registrations are unreliable matches).
            if int(ks[i]) > lc.max_iterations_accept:
                continue
            self.map.edges.append((j, kf_idx))
            self.map.measurements.append(se3.Pose(states.q[i], states.t[i]))
            # Loop closures weighted above odometry links.
            self.map.weights.append(4.0)
            self.map.loop_closures.append((j, kf_idx))
            accepted += 1
        if accepted and self.incremental_optimize and len(self.map.keyframes) >= 2:
            self._incremental_update()

    # -- backend ------------------------------------------------------------

    def _graph(self) -> PoseGraph:
        kfs = self.map.keyframes
        return graph_from_poses([k.pose.q for k in kfs], [k.pose.t for k in kfs],
                                self.map.edges, self.map.measurements,
                                np.asarray(self.map.weights, np.float32))

    def optimize_map(self, iterations: int = 10,
                     use_pcg: bool | None = None) -> PoseGraph:
        """Run the pose-graph backend and write the refined poses back to
        the keyframes (and re-anchor the trajectory).

        ``use_pcg`` selects the matrix-free PCG solver; the default picks
        it for maps beyond the dense 6N solve's comfort zone (> 512
        keyframes)."""
        if len(self.map.keyframes) < 2:
            raise ValueError("need at least two keyframes to optimize")
        graph = self._graph()
        if use_pcg is None:
            use_pcg = len(self.map.keyframes) > 512
        out = (optimize_pcg if use_pcg else optimize)(graph, iterations=iterations)
        self._apply_refined(out.q, out.t)
        return out

    def _apply_refined(self, out_q, out_t) -> None:
        """Write refined keyframe poses back and re-anchor the trajectory:
        every frame between keyframe k and the next inherits k's
        world-frame correction corr_k = refined_k o old_k^-1, so ATE
        reporting, checkpoints and odometry resume all see the optimized
        poses (keyframe frames land exactly on their refined pose)."""
        kfs = self.map.keyframes
        old = se3.Pose(torch.stack([kf.pose.q for kf in kfs]),
                       torch.stack([kf.pose.t for kf in kfs]))
        corr = se3.compose(se3.Pose(out_q, out_t), se3.inverse(old))
        for i, kf in enumerate(kfs):
            kf.pose = se3.Pose(out_q[i], out_t[i])
        kf_frames = [kf.index for kf in kfs]
        frames, owners = [], []
        ki = 0
        for f in range(len(self.trajectory)):
            while ki + 1 < len(kf_frames) and f >= kf_frames[ki + 1]:
                ki += 1
            if f >= kf_frames[0]:
                frames.append(f)
                owners.append(ki)
        if frames:
            own = torch.as_tensor(owners, device=out_t.device)
            new = se3.compose(se3.Pose(corr.q[own], corr.t[own]),
                              se3.Pose(torch.stack([self.trajectory[f].q for f in frames]),
                                       torch.stack([self.trajectory[f].t for f in frames])))
            for n, f in enumerate(frames):
                self.trajectory[f] = se3.Pose(new.q[n], new.t[n])
        self._rebuild_grid()  # keyframe positions moved

    def _incremental_update(self) -> None:
        """A few warm-started iterations right after an accepted loop
        closure (iSAM-style incremental smoothing). Padded nodes and edges
        contribute nothing (pose_graph.pad_nodes / pad_edges)."""
        k = len(self.map.keyframes)
        n_pad = 1 << max(1, (k - 1).bit_length())
        graph = pad_edges(pad_nodes(self._graph(), n_pad), 64)
        solve = optimize_pcg if graph.q.shape[0] > 512 else optimize
        out = solve(graph, iterations=self.incremental_iterations)
        self._apply_refined(out.q[:k], out.t[:k])
        self.n_incremental_updates += 1
