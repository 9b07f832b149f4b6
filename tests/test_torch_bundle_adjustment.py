"""``icp_tpu_torch.slam.bundle_adjustment`` against
``icp_tpu.slam.bundle_adjustment``, mirroring tests/test_bundle_adjustment.py
on the same problems (built by the JAX test's fixture and handed to the
port as numpy arrays), plus a problem whose landmarks have uneven degrees,
so the grouped table has empty slots.

Tolerances: ``ba_cost`` within 1e-5 relative; after ``ba_solve`` the poses
and points within 1e-3 mm of JAX's and the cost within 1e-4 relative (the
port sums onto the cameras with one-hot products and onto the landmarks
over the grouped table, JAX by scatter-adds: float32 rounding apart).
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.slam import bundle_adjustment as JB
from icp_tpu.slam import se3 as J3
from icp_tpu_torch.slam import bundle_adjustment as TB
from tests.test_bundle_adjustment import _make_problem


def _to_torch(problem) -> TB.BAProblem:
    out = []
    for x in problem:
        a = np.array(x)
        out.append(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a))
    return TB.BAProblem(*out)


def _agree(tout, jout):
    np.testing.assert_allclose(tout.pose_t.numpy(), np.asarray(jout.pose_t), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tout.pose_q.numpy(), np.asarray(jout.pose_q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points), rtol=0, atol=1e-3)
    cj, ct = float(JB.ba_cost(jout)), float(TB.ba_cost(tout))
    assert abs(ct - cj) <= 1e-4 * max(cj, 1e-3), (ct, cj)


def test_ba_perfect_initialization_stays():
    prob, _, _ = _make_problem(np.random.default_rng(42))
    tprob = _to_torch(prob)
    out = TB.ba_solve(tprob, iterations=3)
    np.testing.assert_allclose(out.pose_t.numpy(), tprob.pose_t.numpy(), atol=1e-2)
    np.testing.assert_allclose(out.points.numpy(), tprob.points.numpy(), atol=1e-2)
    _agree(out, JB.ba_solve(prob, iterations=3))


def test_ba_recovers_from_perturbation():
    prob, gt_poses, pts = _make_problem(np.random.default_rng(42), perturb=0.01)
    tprob = _to_torch(prob)
    c0 = float(TB.ba_cost(tprob))
    assert abs(c0 - float(JB.ba_cost(prob))) <= 1e-5 * c0
    out = TB.ba_solve(tprob, iterations=8)
    c1 = float(TB.ba_cost(out))
    assert c1 < c0 * 1e-3, (c0, c1)
    for k in range(1, 4):
        np.testing.assert_allclose(out.pose_t[k].numpy(), np.asarray(gt_poses[k].t), atol=0.5)
    np.testing.assert_allclose(out.points.numpy(), pts, atol=0.5)
    _agree(out, JB.ba_solve(prob, iterations=8))


def test_ba_noisy_observations_reduce_cost():
    prob, *_ = _make_problem(np.random.default_rng(42), noise=2.0, perturb=0.02)
    tprob = _to_torch(prob)
    out = TB.ba_solve(tprob, iterations=8)
    assert float(TB.ba_cost(out)) < float(TB.ba_cost(tprob)) * 0.5
    _agree(out, JB.ba_solve(prob, iterations=8))


def test_ba_anchor_fixed():
    prob, *_ = _make_problem(np.random.default_rng(42), perturb=0.02)
    out = TB.ba_solve(_to_torch(prob), iterations=5)
    np.testing.assert_allclose(out.pose_t[0].numpy(), np.asarray(prob.pose_t[0]), atol=1e-3)


def test_ba_uneven_degrees_match_jax():
    """Landmarks seen by 1 to 5 of 6 cameras (and one by none): the grouped
    table's empty slots must add nothing."""
    rng = np.random.default_rng(5)
    n_cams, n_pts = 6, 120
    poses = [J3.Pose(jnp.asarray(np.array([0, np.sin(0.02 * k), 0, np.cos(0.02 * k)],
                                          np.float32)),
                     jnp.asarray(np.array([60.0 * k, 4.0 * k, 10.0 * k], np.float32)))
             for k in range(n_cams)]
    pts = np.stack([rng.uniform(-500, 500, n_pts), rng.uniform(-400, 400, n_pts),
                    rng.uniform(1200, 2200, n_pts)], 1).astype(np.float32)
    cam, pid, zs = [], [], []
    for l in range(n_pts - 1):  # the last point has no observation
        for k in rng.choice(n_cams, size=rng.integers(1, 6), replace=False):
            cam.append(int(k))
            pid.append(l)
            zs.append(np.asarray(J3.apply(J3.inverse(poses[k]), jnp.asarray(pts[l])))
                      + rng.normal(0, 1.0, 3))
    xi = (rng.normal(size=(n_cams, 6)) * 0.01).astype(np.float32)
    xi[:, :3] *= 30.0
    xi[0] = 0.0
    init = [J3.retract(p, jnp.asarray(x)) for p, x in zip(poses, xi)]
    prob = JB.BAProblem(
        pose_q=jnp.stack([p.q for p in init]), pose_t=jnp.stack([p.t for p in init]),
        points=jnp.asarray(pts + rng.normal(0, 2.0, pts.shape).astype(np.float32)),
        obs_cam=jnp.asarray(np.asarray(cam, np.int32)),
        obs_point=jnp.asarray(np.asarray(pid, np.int32)),
        obs_z=jnp.asarray(np.asarray(zs, np.float32)),
        obs_w=jnp.asarray(rng.uniform(0.5, 2.0, len(cam)).astype(np.float32)))
    tprob = _to_torch(prob)
    assert TB.check_max_degree(tprob.obs_point, n_pts, 8) == 5
    out = TB.ba_solve(tprob, iterations=4)
    assert float(TB.ba_cost(out)) < float(TB.ba_cost(tprob)) * 0.1
    _agree(out, JB.ba_solve(prob, iterations=4))


def test_ba_max_degree_overflow_raises():
    """A landmark observed more than max_degree times is refused, with the
    JAX package's error, not silently dropped from the Schur terms."""
    prob, *_ = _make_problem(np.random.default_rng(42), n_cams=3, n_pts=4)
    tprob = _to_torch(prob)._replace(obs_point=torch.zeros(12, dtype=torch.int64))
    with pytest.raises(ValueError, match="max_degree") as got:
        TB.ba_solve(tprob, iterations=1, max_degree=8)
    with pytest.raises(ValueError, match="max_degree") as want:
        JB.ba_solve(prob._replace(obs_point=jnp.zeros_like(prob.obs_point)), iterations=1,
                    max_degree=8)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    assert TB.check_max_degree(tprob.obs_point, 4, 12) == 12
