"""``icp_tpu_torch.slam.mapping.SlamEngine`` and ``slam.checkpoint``
against the JAX package's, mirroring tests/test_slam_engine.py (its
``pad_nodes`` case is in tests/test_torch_pose_graph.py; its orbax case
has no twin: orbax is a JAX library, and the port's ``backend="orbax"``
raises).

Both engines get the same landmarks, made by the JAX package's renderer
from the JAX test's trajectories and handed over as numpy arrays. Size:
the port's CPU twins of the kernels cost ~0.5 s a step at the flagship
(16384 landmarks, n_r 256) on one core, so the engines here run on the
64x64 subsample of each frame's landmark grid (m 4096, n_r 64) in both
packages; the pyramid case needs the full 128x128 grid and runs it with
``max_iterations`` 16 in both.

Tolerances: keyframe indices, edges, weights and loop-closure sets equal;
each registration within the slice tolerances of
tests/test_torch_slice.py (t within 0.01 mm), composed along the chain,
so trajectory and measurement translations within 0.05 mm and
quaternions within 1e-5; after ``optimize_map`` the keyframes within
1 mm and 2e-2 in q. Rotation residuals are in radians beside
translation residuals in mm, so the LM trades keyframe rotation, which
costs little, for translation consistency: five iterations turn the
keyframes of this loop by up to ~8 deg in both packages, far from
converged along that soft direction, where two float32 solves part by
up to ~1e-2 in q and a few tenths of a mm in t (the card against the
CPU: 7.8e-3 and 0.27 mm).
Where a closure's ``k`` sits at ``max_iterations_accept`` the float32
floor could split the closure sets: a failure message prints both sides'
``k``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.pyramid import subsample_grid
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu.sensors import synthetic
from icp_tpu.slam import checkpoint as JC
from icp_tpu.slam import mapping as JM
from icp_tpu.slam.odometry import KeyframePolicy as JK
from icp_tpu_torch.slam import checkpoint as TC
from icp_tpu_torch.slam import mapping as TM
from icp_tpu_torch.slam.odometry import KeyframePolicy as TK
from tests.test_slam_engine import _loop_trajectory

M_S, N_R_S = 4096, 64
T_TOL, Q_TOL = 0.05, 1e-5
OPT_T_TOL, OPT_Q_TOL = 1.0, 2e-2


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def frames():
    """Landmarks of the JAX test's trajectories: n -> (poses, full
    (16384, 8) grids, (4096, 8) subsamples)."""
    scene = synthetic.default_scene()
    out = {}
    for n in (3, 5):
        poses = _loop_trajectory(n)
        full = [np.array(get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8)))
                for p in poses]
        out[n] = (poses, full, [np.array(subsample_grid(jnp.asarray(f), 2)) for f in full])
    return out


def _engines(m=M_S, n_r=N_R_S, max_iterations=40, **kw):
    """(JAX engine, port engine) with the JAX test's settings."""
    je = JM.SlamEngine(icp_tpu.ICPParams(alpha=2e2),
                       icp_tpu.ICPConfig(m=m, n_r=n_r, estimate_scale=False,
                                         max_iterations=max_iterations),
                       policy=JK(max_gap=1),
                       loop_config=JM.LoopClosureConfig(min_gap=3, max_distance=100.0), **kw)
    te = TM.SlamEngine(icp_tpu_torch.ICPParams(alpha=2e2),
                       icp_tpu_torch.ICPConfig(m=m, n_r=n_r, estimate_scale=False,
                                               max_iterations=max_iterations),
                       policy=TK(max_gap=1),
                       loop_config=TM.LoopClosureConfig(min_gap=3, max_distance=100.0), **kw)
    return je, te


def _feed(je, te, lms):
    for f in lms:
        je.process_frame(jnp.asarray(f))
        te.process_frame(torch.from_numpy(f))


def _closure_ks(je, te) -> str:
    """Both sides' ``k`` on each closure that only one side accepted."""
    lines = []
    for i, j in sorted(set(te.map.loop_closures) ^ set(je.map.loop_closures)):
        kj = int(icp_tpu.register(je.map.keyframes[i].landmarks, je.map.keyframes[j].landmarks,
                                  je.params, je.config).k)
        kt = int(icp_tpu_torch.register(te.map.keyframes[i].landmarks,
                                        te.map.keyframes[j].landmarks, te.params, te.config).k)
        lines.append(f"closure ({i}, {j}): k JAX {kj}, port {kt} (accept at <= "
                     f"{te.loop_config.max_iterations_accept})")
    return "closure sets differ: " + "; ".join(lines)


def _same_map(je, te, t_tol=T_TOL, q_tol=Q_TOL, msg=""):
    """The port's map against JAX's: the same structure, poses within
    ``t_tol`` mm and ``q_tol`` (``msg`` joins a failure's message)."""
    assert len(te.trajectory) == len(je.trajectory)
    assert [k.index for k in te.map.keyframes] == [k.index for k in je.map.keyframes]
    assert te.map.edges == [tuple(map(int, e)) for e in je.map.edges]
    assert te.map.weights == list(map(float, je.map.weights))
    assert te.map.loop_closures == je.map.loop_closures, _closure_ks(je, te)
    for a, b in [(p, q) for p, q in zip(te.trajectory, je.trajectory)] + \
            [(k.pose, l.pose) for k, l in zip(te.map.keyframes, je.map.keyframes)] + \
            list(zip(te.map.measurements, je.map.measurements)):
        np.testing.assert_allclose(a.t.cpu().numpy(), np.asarray(b.t), rtol=0, atol=t_tol,
                                   err_msg=msg)
        np.testing.assert_allclose(np.abs(a.q.cpu().numpy()), np.abs(np.asarray(b.q)), rtol=0,
                                   atol=q_tol, err_msg=msg)


@pytest.fixture(scope="module")
def loop5(frames):
    """Both engines over the 5-frame there-and-back loop, every frame a
    keyframe; the maps before, then the engines after optimize_map(5)."""
    je, te = _engines()
    _feed(je, te, frames[5][2])
    before = (len(je.map.loop_closures), len(te.map.loop_closures))
    _same_map(je, te)
    je.optimize_map(iterations=5)
    te.optimize_map(iterations=5)
    return je, te, before


def test_engine_tracks_and_closes_loop(frames, loop5):
    je, te, (nj, nt) = loop5
    poses = frames[5][0]
    assert len(te.trajectory) == 5 and len(te.map.keyframes) == 5
    assert nt == nj >= 1  # the return to the start closes a loop
    # The backend keeps the anchor fixed and does not blow up.
    assert float(torch.linalg.vector_norm(te.map.keyframes[0].pose.t)) < 1e-3
    for kf, gt in zip(te.map.keyframes, poses):
        err = np.linalg.norm(kf.pose.t.numpy() - np.asarray(gt.t))
        assert err < 20.0, err
    _same_map(je, te, OPT_T_TOL, OPT_Q_TOL)


def test_optimize_map_reanchors_trajectory(loop5):
    """After optimize_map the trajectory carries the refined keyframe
    poses (ATE reporting, checkpoints and resume read the trajectory)."""
    _, te, _ = loop5
    for kf in te.map.keyframes:
        np.testing.assert_allclose(te.trajectory[kf.index].t.numpy(), kf.pose.t.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(np.abs(te.trajectory[kf.index].q.numpy()),
                                   np.abs(kf.pose.q.numpy()), atol=1e-5)
    # The grid mirrors moved with the keyframes.
    np.testing.assert_allclose(np.stack(te._kf_pos),
                               np.stack([kf.pose.t.numpy() for kf in te.map.keyframes]))


def test_engine_incremental_optimize(frames):
    """iSAM-style mode: each accepted closure triggers a warm-started
    smoothing pass, so the poses are near-optimal with no final
    optimize_map, in both packages alike."""
    je, te = _engines(incremental_optimize=True, incremental_iterations=5)
    _feed(je, te, frames[5][2])
    assert len(te.map.loop_closures) >= 1
    assert te.n_incremental_updates == je.n_incremental_updates >= 1
    assert float(torch.linalg.vector_norm(te.map.keyframes[0].pose.t)) < 1e-3
    for kf, gt in zip(te.map.keyframes, frames[5][0]):
        assert np.linalg.norm(kf.pose.t.numpy() - np.asarray(gt.t)) < 20.0
    for kf in te.map.keyframes:
        np.testing.assert_allclose(te.trajectory[kf.index].t.numpy(), kf.pose.t.numpy(),
                                   atol=1e-4)
    _same_map(je, te, OPT_T_TOL, OPT_Q_TOL)


def _poses(engine) -> list:
    """An engine's trajectory, keyframe poses and measurements."""
    return (list(engine.trajectory) + [k.pose for k in engine.map.keyframes]
            + list(engine.map.measurements))


def test_engine_with_pyramid(frames):
    """The pyramid engine (strides 4, 1) on the full landmark grids.

    Its quaternions are held to the reference's own spread, measured on the
    host the test runs on: the JAX engine fed the same frames with the
    first frame's landmarks moved one float32 ulp up, then down. The bar is
    the larger of Q_TOL and four times the largest |q| difference that
    moves. (On one host the port and JAX part by 1.23e-5 under every ATen
    capability, and the ulp moves the JAX engine's own poses by 3.1e-6 and
    1.7e-5.)
    """
    je, te = _engines(m=16384, n_r=256, max_iterations=16, use_pyramid=True,
                      pyramid_strides=(4, 1))
    poses, full, _ = frames[3]
    _feed(je, te, full)
    assert len(te.trajectory) == 3
    for kf, gt in zip(te.map.keyframes, poses):
        assert np.linalg.norm(kf.pose.t.numpy() - np.asarray(gt.t)) < 20.0
    moved = []
    for d in (np.inf, -np.inf):
        je_d, _ = _engines(m=16384, n_r=256, max_iterations=16, use_pyramid=True,
                           pyramid_strides=(4, 1))
        for f in [np.nextafter(full[0], np.float32(d))] + full[1:]:
            je_d.process_frame(jnp.asarray(f))
        moved.append(je_d)
    spread = max(float(np.abs(np.abs(np.asarray(a.q)) - np.abs(np.asarray(b.q))).max())
                 for other in moved for a, b in zip(_poses(je), _poses(other)))
    q_tol = max(Q_TOL, 4 * spread)
    _same_map(je, te, q_tol=q_tol,
              msg=f"reference spread in q {spread}, bar {q_tol}")


def _check_restored(te2, te):
    assert len(te2.trajectory) == len(te.trajectory)
    assert len(te2.map.keyframes) == len(te.map.keyframes)
    assert te2.map.edges == te.map.edges
    assert te2.map.loop_closures == te.map.loop_closures
    assert te2.map.weights == te.map.weights
    for a, b in zip(te2.trajectory + [k.pose for k in te2.map.keyframes] + te2.map.measurements,
                    te.trajectory + [k.pose for k in te.map.keyframes] + te.map.measurements):
        np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
    for a, b in zip(te2.map.keyframes, te.map.keyframes):
        np.testing.assert_array_equal(np.asarray(a.landmarks), np.asarray(b.landmarks))
    np.testing.assert_array_equal(np.asarray(te2._prev_lms), np.asarray(te._prev_lms))


def test_checkpoint_roundtrip(tmp_path, frames, loop5):
    _, te, _ = loop5
    path = TC.save_session(te, str(tmp_path / "session"))
    te2 = TC.load_session(path, _engines()[1], device="cpu")
    _check_restored(te2, te)
    assert all(k.pose.t.device.type == "cpu" for k in te2.map.keyframes)
    # The resumed engine keeps processing frames.
    te2.process_frame(torch.from_numpy(frames[5][2][0]))
    assert len(te2.trajectory) == len(te.trajectory) + 1


def test_checkpoint_loads_across_packages(tmp_path, frames, loop5):
    """A session saved by either package loads in the other (the JAX
    config's ``use_pallas`` is skipped by the port, and defaulted by JAX),
    and both resume the same frame alike."""
    je, te, _ = loop5
    te_from_j = TC.load_session(JC.save_session(je, str(tmp_path / "jax")), device="cpu")
    je_from_t = JC.load_session(TC.save_session(te, str(tmp_path / "port")))
    _check_restored(te_from_j, je)
    _check_restored(je_from_t, te)
    assert TC._config_dict(te_from_j.config) == {
        k: v for k, v in JC._config_dict(je.config).items() if k != "use_pallas"}
    assert JC._config_dict(je_from_t.config) == JC._config_dict(je.config)
    assert te_from_j.policy == te.policy and te_from_j.loop_config == te.loop_config
    assert je_from_t.policy == je.policy and je_from_t.loop_config == je.loop_config
    with np.load(str(tmp_path / "jax.npz")) as a, np.load(str(tmp_path / "port.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
    frame = frames[5][2][0]
    pj = je_from_t.process_frame(jnp.asarray(frame))
    pt = te_from_j.process_frame(torch.from_numpy(frame))
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=OPT_T_TOL)


def test_checkpoint_restores_full_config(tmp_path, frames):
    """load_session(engine=None) rebuilds the SAVED algorithm
    configuration, not defaults; the JAX package rebuilds the same from
    the port's snapshot."""
    eng = TM.SlamEngine(
        icp_tpu_torch.ICPParams(alpha=3e2, translation_threshold=0.02),
        icp_tpu_torch.ICPConfig(estimate_scale=False, objective=icp_tpu_torch.Objective.PLANE,
                                rotation=icp_tpu_torch.RotationMode.SVD, max_iterations=25),
        policy=TK(max_gap=2, max_translation=55.0),
        loop_config=TM.LoopClosureConfig(min_gap=4, max_distance=123.0),
        use_pyramid=True, pyramid_strides=(2, 1),
    )
    eng.process_frame(torch.from_numpy(frames[3][1][0]))  # the first frame registers nothing
    path = TC.save_session(eng, str(tmp_path / "cfg"))
    eng2 = TC.load_session(path, device="cpu")
    assert eng2.config == eng.config
    assert float(eng2.params.alpha) == float(eng.params.alpha)
    assert float(eng2.params.translation_threshold) == float(eng.params.translation_threshold)
    assert eng2.policy == eng.policy and eng2.loop_config == eng.loop_config
    assert eng2.use_pyramid is True and eng2.pyramid_strides == (2, 1)
    je = JC.load_session(path)
    assert je.config.objective is icp_tpu.Objective.PLANE
    assert je.config.rotation is icp_tpu.RotationMode.SVD and je.config.max_iterations == 25
    assert je.pyramid_strides == (2, 1) and je.policy.max_translation == 55.0
    assert dataclasses.asdict(je.loop_config) == dataclasses.asdict(eng.loop_config)


def test_checkpoint_orbax_raises(tmp_path, loop5):
    _, te, _ = loop5
    for call in (lambda: TC.save_session(te, str(tmp_path / "o"), backend="orbax"),
                 lambda: TC.load_session(str(tmp_path / "o"), backend="orbax")):
        with pytest.raises(NotImplementedError, match="JAX"):
            call()
