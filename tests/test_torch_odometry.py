"""The port's SE(3) utilities and odometry chain against
``icp_tpu.slam.se3`` and ``icp_tpu.slam.odometry``.

Tolerances: every se3 function within 1e-6 of JAX's (float32, each
package's own quaternion algebra); the autograd Jacobians of ``exp`` and
``log``, at 0 and away from it, within 1e-5 of ``jax.jacfwd``'s. The
device chain is bitwise the host chain of the port. Against JAX, each
frame's registration is held to the slice tolerances of
tests/test_torch_slice.py (``k`` equal, t within 0.01 mm, the angle between
the rotations within 2e-4 deg), torch pinned to one thread; the world poses
compose those, so they are held within 0.02 mm and 4e-4 deg.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.pyramid import subsample_grid as j_subsample
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.sampling import get_landmarks as j_landmarks
from icp_tpu.sensors import synthetic as JY
from icp_tpu.slam import odometry as JO
from icp_tpu.slam import se3 as J3
from icp_tpu_torch.icp.pyramid import subsample_grid as t_subsample
from icp_tpu_torch.ops.sampling import get_landmarks as t_landmarks
from icp_tpu_torch.slam import odometry as TO
from icp_tpu_torch.slam import se3 as T3
from tests.utils import random_quat


def _poses(rng, n=2):
    out = []
    for _ in range(n):
        q = random_quat(rng, 1.0)
        t = rng.normal(size=3).astype(np.float32) * 100
        out.append((J3.Pose(jnp.asarray(q), jnp.asarray(t)),
                    T3.Pose(torch.from_numpy(q), torch.from_numpy(t))))
    return out


def _close(t_pose, j_pose, tol=1e-6):
    assert np.abs(t_pose.q.numpy() - np.asarray(j_pose.q)).max() <= tol
    assert np.abs(t_pose.t.numpy() - np.asarray(j_pose.t)).max() <= tol * 100


def test_se3_functions_match_jax():
    """compose, inverse, relative, retract, apply, rotation_matrix, exp and
    log (translations scaled by 100 mm, so t is held to 1e-4 mm)."""
    rng = np.random.default_rng(0)
    (ja, ta), (jb, tb) = _poses(rng)
    _close(T3.compose(ta, tb), J3.compose(ja, jb))
    _close(T3.inverse(ta), J3.inverse(ja))
    _close(T3.relative(ta, tb), J3.relative(ja, jb))
    pts = rng.normal(size=(10, 3)).astype(np.float32) * 500
    assert np.abs(T3.apply(ta, torch.from_numpy(pts)).numpy()
                  - np.asarray(J3.apply(ja, jnp.asarray(pts)))).max() <= 1e-3
    assert np.abs(T3.rotation_matrix(ta).numpy()
                  - np.asarray(J3.rotation_matrix(ja))).max() <= 1e-6
    for scale in (0.0, 1e-5, 0.3, 2.0):
        xi = rng.normal(size=6).astype(np.float32) * scale
        _close(T3.exp(torch.from_numpy(xi)), J3.exp(jnp.asarray(xi)))
        _close(T3.retract(ta, torch.from_numpy(xi)), J3.retract(ja, jnp.asarray(xi)))
        assert np.abs(T3.log(T3.exp(torch.from_numpy(xi))).numpy()
                      - np.asarray(J3.log(J3.exp(jnp.asarray(xi))))).max() <= 1e-6
    assert np.abs(T3.log(ta).numpy() - np.asarray(J3.log(ja))).max() <= 1e-4
    ident = T3.Pose.identity(device="cpu")
    assert torch.equal(ident.q, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert torch.equal(ident.t, torch.zeros(3))


@pytest.mark.parametrize("at", ["zero", "small", "random"])
def test_exp_log_jacobians_match_jax(at):
    """Autograd through exp and log at xi = 0 (the Taylor branch, where the
    pose graph takes its Jacobians), just inside it and at a random xi:
    finite, and within 1e-5 of jax.jacfwd's."""
    rng = np.random.default_rng(1)
    xi = {"zero": np.zeros(6, np.float32),
          "small": np.float32([1.0, -2.0, 0.5, 3e-5, -2e-5, 4e-5]),
          "random": rng.normal(size=6).astype(np.float32) * 0.4}[at]

    def t_exp(x):
        p = T3.exp(x)
        return torch.cat([p.q, p.t])

    def j_exp(x):
        p = J3.exp(x)
        return jnp.concatenate([p.q, p.t])

    got = torch.autograd.functional.jacobian(t_exp, torch.from_numpy(xi)).numpy()
    want = np.asarray(jax.jacfwd(j_exp)(jnp.asarray(xi)))
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-5

    qt = np.array(j_exp(jnp.asarray(xi)))
    got = torch.autograd.functional.jacobian(
        lambda v: T3.log(T3.Pose(v[:4], v[4:])), torch.from_numpy(qt)).numpy()
    want = np.asarray(jax.jacfwd(lambda v: J3.log(J3.Pose(v[:4], v[4:])))(jnp.asarray(qt)))
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-5


def test_trajectory_errors_match_jax():
    """ATE and RPE on the JAX test's cases (tests/test_se3_odometry.py): a
    perfect trajectory, one 2 mm bad step, deltas 1 and 5."""
    def chain(mod, make, bad_at=None):
        step = mod.Pose(make([0, 0, 0, 1.0]), make([10.0, 0, 0]))
        bad = mod.Pose(step.q, step.t + make([2.0, 0, 0]))
        out = [mod.Pose(make([0, 0, 0, 1.0]), make([0.0, 0, 0]))]
        for i in range(9):
            out.append(mod.compose(out[-1], bad if i == bad_at else step))
        return out

    def tmake(v):
        return torch.tensor(v, dtype=torch.float32)

    def jmake(v):
        return jnp.asarray(np.asarray(v, np.float32))

    jgt, tgt = chain(J3, jmake), chain(T3, tmake)
    jest, test = chain(J3, jmake, bad_at=4), chain(T3, tmake, bad_at=4)
    assert abs(TO.absolute_trajectory_error(test, tgt)
               - JO.absolute_trajectory_error(jest, jgt)) <= 1e-6
    for delta in (1, 5):
        for est_j, est_t in ((jgt, tgt), (jest, test)):
            got = TO.relative_pose_error(est_t, tgt, delta=delta)
            want = JO.relative_pose_error(est_j, jgt, delta=delta)
            np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(TO.relative_pose_error(test, tgt)[0], 2.0 / 3.0, rtol=1e-3)
    with pytest.raises(ValueError):
        TO.relative_pose_error(test[:3], tgt[:3], delta=5)


@pytest.fixture(scope="module")
def orbit():
    """Three frames of the JAX test's orbit (default scene), rendered by
    the JAX package and handed to both as numpy arrays."""
    poses = JY.orbit_trajectory(3, radius_mm=30.0, yaw_rad=0.02)
    return [np.array(JY.render_cloud(JY.default_scene(), p)) for p in poses]


@pytest.mark.parametrize("objective", ["point", "gicp"])
def test_odometry_chains_match_jax(orbit, objective):
    """On 4096 landmarks a frame (every other row and column of the 16384),
    m 4096, n_r 64: the port's device chain is bitwise its host chain
    (poses and k), and both meet JAX's run_odometry within the slice
    tolerances; the keyframes agree (max_gap 2)."""
    jc = icp_tpu.ICPConfig(m=4096, n_r=64, estimate_scale=False,
                           objective=icp_tpu.Objective(objective))
    tc = icp_tpu_torch.ICPConfig(m=4096, n_r=64, estimate_scale=False,
                                 objective=icp_tpu_torch.Objective(objective))
    policy_j, policy_t = JO.KeyframePolicy(max_gap=2), TO.KeyframePolicy(max_gap=2)
    jr = JO.run_odometry([jnp.asarray(f) for f in orbit], icp_tpu.ICPParams(alpha=2e2).as_f32(),
                         jc, policy_j, to_landmarks=lambda f: j_subsample(
                             j_landmarks(f.reshape(-1, 8)), 2))
    tr = TO.run_odometry([torch.from_numpy(f) for f in orbit], icp_tpu_torch.ICPParams(alpha=2e2),
                         tc, policy_t, to_landmarks=lambda f: t_subsample(
                             t_landmarks(f.reshape(-1, 8)), 2).contiguous())
    lms = torch.stack([t_subsample(t_landmarks(torch.from_numpy(f).reshape(-1, 8)), 2)
                       for f in orbit])
    q, t, ks = TO.odometry_chain_device(lms, icp_tpu_torch.ICPParams(alpha=2e2), tc)

    assert q.shape == (3, 4) and t.shape == (3, 3) and ks.shape == (2,)
    for i, pose in enumerate(tr.poses):
        assert torch.equal(q[i], pose.q) and torch.equal(t[i], pose.t)
    assert ks.tolist() == [int(s.k) for s in tr.relative]
    assert tr.keyframes == jr.keyframes == [0, 2]

    for ts, js in zip(tr.relative, jr.relative):
        assert int(ts.k) == int(js.k)
        assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
        assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 2e-4
    for tp, jp in zip(tr.poses, jr.poses):
        assert np.linalg.norm(tp.t.numpy() - np.asarray(jp.t)) <= 0.02
        assert float(qangle_deg(qmul(jnp.asarray(tp.q.numpy()), qconj(jp.q)))) <= 4e-4


def test_icp_run_without_reads_is_bitwise():
    """icp_run with reads=False (every chunk, steps past the stop frozen)
    gives icp_run's state bit for bit, on a pair that converges inside the
    first chunk and on one stopped by max_iterations mid-chunk."""
    from icp_tpu_torch.icp.run import build_index, icp_run
    from icp_tpu_torch.sensors.synthetic import synthetic_pair

    fixed, moving = (torch.from_numpy(a) for a in synthetic_pair(4096))
    params = icp_tpu_torch.ICPParams(alpha=2e2).to("cpu")
    for max_it in (20, 11):
        cfg = icp_tpu_torch.ICPConfig(m=4096, n_r=64, max_iterations=max_it)
        index = build_index(fixed, params, cfg)
        a = icp_run(moving, index, params, cfg)
        b = icp_run(moving, index, params, cfg, reads=False)
        for f in ("q", "t", "s", "qk", "tk", "sk", "k"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    fast = icp_tpu_torch.ICPParams(alpha=2e2, angle_threshold_deg=0.0,
                                   translation_threshold=0.0)
    b = icp_run(moving, index, fast, cfg, reads=False)
    assert int(b.k) == 11


def test_host_chain_keeps_frames_on_their_device(orbit):
    """Numpy frames go to the card (raising without one); CPU tensors stay
    on the CPU, poses included."""
    cfg = icp_tpu_torch.ICPConfig(m=4096, n_r=64, estimate_scale=False, max_iterations=2)

    def lms(f):
        return t_subsample(t_landmarks(f.reshape(-1, 8)), 2).contiguous()

    res = TO.run_odometry([torch.from_numpy(f) for f in orbit[:2]],
                          icp_tpu_torch.ICPParams(alpha=2e2), cfg, to_landmarks=lms)
    assert all(p.q.device.type == "cpu" for p in res.poses)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TO.frame_to_landmarks(orbit[0])
