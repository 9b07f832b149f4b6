"""Checkpoint / resume for SLAM sessions (port of
``icp_tpu.slam.checkpoint``).

One backend: a versioned single-file npz snapshot, in the same format
(keys, meta JSON, ``FORMAT_VERSION``) as the JAX package's, so a session
saved by either package loads in the other. The JAX package's orbax
backend is a JAX library; the port runs where JAX is not installed, so
``backend="orbax"`` raises.

Snapshot content: trajectory, keyframes (pose, landmarks, frame index),
pose-graph edges / measurements / weights, loop closures, the last frame's
landmarks and the engine's full configuration.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from icp_tpu_torch.runtime.config import (Correspondence, ICPConfig, ICPParams, Objective,
                                          RobustKernel, RotationMode, Weighting)
from icp_tpu_torch.slam import se3
from icp_tpu_torch.slam.mapping import Keyframe, LoopClosureConfig, SlamEngine, SlamMap
from icp_tpu_torch.slam.odometry import KeyframePolicy

FORMAT_VERSION = 1

_ORBAX = ("the orbax backend is a JAX library and this package runs without JAX; "
          "use backend='npz' (the JAX package reads its npz snapshots too)")


def _to_np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _payload(engine: SlamEngine) -> dict:
    m = engine.map
    if not engine.trajectory:
        raise ValueError("nothing to save: engine has processed no frames")
    return {
        # The LAST PROCESSED frame's landmarks (not the last keyframe's):
        # odometry resumes relative to trajectory[-1], so _prev_lms must be
        # that frame's landmarks or every post-resume pose inherits the
        # keyframe-to-frame offset.
        "last_lms": (_to_np(engine._prev_lms)
                     if engine._prev_lms is not None
                     else np.zeros((0, 8), np.float32)),
        "version": np.int32(FORMAT_VERSION),
        "traj_q": np.stack([_to_np(p.q) for p in engine.trajectory]),
        "traj_t": np.stack([_to_np(p.t) for p in engine.trajectory]),
        "kf_index": np.asarray([k.index for k in m.keyframes], np.int32),
        "kf_q": np.stack([_to_np(k.pose.q) for k in m.keyframes]),
        "kf_t": np.stack([_to_np(k.pose.t) for k in m.keyframes]),
        "kf_landmarks": np.stack([_to_np(k.landmarks) for k in m.keyframes]),
        "edges": np.asarray(m.edges, np.int32).reshape(-1, 2),
        "meas_q": (np.stack([_to_np(z.q) for z in m.measurements])
                   if m.measurements else np.zeros((0, 4), np.float32)),
        "meas_t": (np.stack([_to_np(z.t) for z in m.measurements])
                   if m.measurements else np.zeros((0, 3), np.float32)),
        "weights": np.asarray(m.weights, np.float32),
        "loop_closures": np.asarray(m.loop_closures, np.int32).reshape(-1, 2),
        "meta": np.frombuffer(json.dumps({
            "m": engine.config.m,
            "n_r": engine.config.n_r,
            "gap_since_kf": engine._gap_since_kf,
            # Full algorithm configuration: a resumed session must run the
            # SAME algorithm that produced the snapshot, not defaults.
            "config": _config_dict(engine.config),
            "params": {f.name: float(getattr(engine.params, f.name))
                       for f in dataclasses.fields(ICPParams)},
            "policy": dataclasses.asdict(engine.policy),
            "loop_config": dataclasses.asdict(engine.loop_config),
            "use_pyramid": engine.use_pyramid,
            "pyramid_strides": list(engine.pyramid_strides),
        }).encode(), dtype=np.uint8),
    }


def _config_dict(config: ICPConfig) -> dict:
    """ICPConfig -> JSON-safe dict (enums by value)."""
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        out[f.name] = v.value if isinstance(v, enum.Enum) else v
    return out


def _config_from_dict(d: dict) -> ICPConfig:
    """Inverse of :func:`_config_dict`; fields this package does not have
    (the JAX package's ``use_pallas``) are skipped."""
    enums = {"rotation": RotationMode, "weighting": Weighting,
             "correspondence": Correspondence, "objective": Objective,
             "robust": RobustKernel}
    valid = {f.name for f in dataclasses.fields(ICPConfig)}
    return ICPConfig(**{k: enums[k](v) if k in enums else v
                        for k, v in d.items() if k in valid})


def save_session(engine: SlamEngine, path: str, backend: str = "npz") -> str:
    """Snapshot an engine into one compressed file (``.npz`` is appended
    to ``path`` when missing); returns the file's path."""
    if backend == "orbax":
        raise NotImplementedError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    payload = _payload(engine)
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


def load_session(path: str, engine: Optional[SlamEngine] = None,
                 backend: str = "npz", device="cuda") -> SlamEngine:
    """Restore a SlamEngine from a snapshot, its tensors on ``device``. If
    ``engine`` is given, its params / config are kept and only the state is
    restored; otherwise the saved configuration is rebuilt."""
    if backend == "orbax":
        raise NotImplementedError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    version = int(data["version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot version {version}")

    meta = json.loads(bytes(data["meta"]).decode())
    if engine is None:
        # Rebuild the engine with the SAVED configuration: algorithm
        # variant, thresholds and policies, not just the shapes.
        if "config" in meta:
            engine = SlamEngine(
                params=ICPParams(**meta["params"]),
                config=_config_from_dict(meta["config"]),
                policy=KeyframePolicy(**meta["policy"]),
                loop_config=LoopClosureConfig(**meta["loop_config"]),
                use_pyramid=bool(meta.get("use_pyramid", False)),
                pyramid_strides=tuple(meta.get("pyramid_strides", (4, 2, 1))),
            )
        else:  # legacy snapshot: shapes only, everything else defaulted
            warnings.warn(
                "legacy snapshot without full config: non-shape settings "
                "(objective, weighting, rotation mode, policies) are "
                "defaulted", stacklevel=2)
            engine = SlamEngine(config=ICPConfig(
                m=int(meta["m"]), n_r=int(meta["n_r"]), estimate_scale=False))

    def dev(a):
        return torch.as_tensor(a, device=device)

    def get(key, shape, dtype):
        return data[key] if key in data else np.zeros(shape, dtype)

    eng = engine
    eng.trajectory = [se3.Pose(dev(q), dev(t)) for q, t in zip(data["traj_q"], data["traj_t"])]
    m = SlamMap()
    for idx, q, t, lms in zip(data["kf_index"], data["kf_q"], data["kf_t"],
                              data["kf_landmarks"]):
        m.keyframes.append(Keyframe(int(idx), se3.Pose(dev(q), dev(t)), dev(lms)))
    m.edges = [tuple(int(v) for v in e) for e in get("edges", (0, 2), np.int32)]
    m.measurements = [se3.Pose(dev(q), dev(t)) for q, t in
                      zip(get("meas_q", (0, 4), np.float32), get("meas_t", (0, 3), np.float32))]
    m.weights = [float(w) for w in get("weights", (0,), np.float32)]
    m.loop_closures = [tuple(int(v) for v in e)
                       for e in get("loop_closures", (0, 2), np.int32)]
    eng.map = m
    eng._rebuild_grid()  # loop-closure spatial index over the restored poses
    eng._gap_since_kf = int(meta.get("gap_since_kf", 0))
    last = get("last_lms", (0, 8), np.float32)
    if last.size:
        eng._prev_lms = dev(last)
    elif m.keyframes:  # legacy snapshots without last_lms
        eng._prev_lms = m.keyframes[-1].landmarks
    return eng
