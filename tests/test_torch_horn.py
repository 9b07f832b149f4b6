"""icp_tpu_torch quaternions and Horn solves against icp_tpu's, on the same
numpy inputs (rtol 1e-5, atol 1e-6), plus the reference's embedded golden."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.icp import horn as JH
from icp_tpu.icp import quaternion as JQ
from icp_tpu_torch.icp import horn as TH
from icp_tpu_torch.icp import quaternion as TQ
from tests.goldens import REF_MEANS, REF_S11, REF_SVD_TK, golden_s_matrix
from tests.utils import make_cloud8, random_quat

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def test_quaternion_ops_match_jax(rng):
    q1 = random_quat(rng, 0.7)
    q2 = random_quat(rng, 0.3)
    pts = make_cloud8(rng, 64)
    t = rng.normal(size=3).astype(np.float32) * 10
    s = np.float32(1.01)
    pairs = [
        (JQ.qnormalize(jnp.asarray(q1 * 2)), TQ.qnormalize(_t(q1 * 2))),
        (JQ.qconj(jnp.asarray(q1)), TQ.qconj(_t(q1))),
        (JQ.qmul(jnp.asarray(q1), jnp.asarray(q2)), TQ.qmul(_t(q1), _t(q2))),
        (JQ.qrotate(jnp.asarray(q1), jnp.asarray(pts[:, :3])),
         TQ.qrotate(_t(q1), _t(pts[:, :3]))),
        (JQ.quat_to_matrix(jnp.asarray(q1)), TQ.quat_to_matrix(_t(q1))),
        (JQ.matrix_to_quat(JQ.quat_to_matrix(jnp.asarray(q2))),
         TQ.matrix_to_quat(TQ.quat_to_matrix(_t(q2)))),
        (JQ.transform_points(jnp.asarray(pts), jnp.asarray(q1),
                             jnp.asarray(t), jnp.float32(s)),
         TQ.transform_points(_t(pts), _t(q1), _t(t), torch.tensor(s))),
    ]
    for j, p in pairs:
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
    # qangle_deg is ill-conditioned near 0 (atan2 of a small |v|), so it is
    # compared on a rotation of a few tenths of a degree and up.
    np.testing.assert_allclose(TQ.qangle_deg(_t(q1)).numpy(),
                               np.asarray(JQ.qangle_deg(jnp.asarray(q1))),
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["power", "svd", "jacobi"])
def test_reference_golden_triplet(mode):
    """The reference test's S / means -> T_k golden (testsICP.cpp:1008-1046),
    and the JAX solve of the same input."""
    args = (REF_S11, REF_MEANS[0], REF_MEANS[1])
    qk, tk, sk = TH.solve_step_transform(*map(_t, args), mode=mode)
    got = np.concatenate([qk.numpy(), tk.numpy(), [float(sk)]])
    np.testing.assert_allclose(got, REF_SVD_TK, atol=42000 * np.finfo(np.float32).eps)
    jq, jt, js = JH.solve_step_transform(*map(jnp.asarray, args), mode=mode)
    np.testing.assert_allclose(qk.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(sk), float(js), **TOL)


@pytest.mark.parametrize("mode", ["power", "svd", "jacobi"])
@pytest.mark.parametrize("estimate_scale", [True, False])
def test_solve_matches_jax_on_known_rotation(rng, mode, estimate_scale):
    q_true = random_quat(rng, 0.4)
    t_true = rng.normal(size=3).astype(np.float32) * 20
    fixed = make_cloud8(rng, 512)
    Rt = np.asarray(JQ.quat_to_matrix(jnp.asarray(q_true)))
    moving = fixed.copy()
    moving[:, :3] = (fixed[:, :3] - t_true) @ Rt
    mf, mm = fixed[:, :3].mean(0), moving[:, :3].mean(0)
    S11 = golden_s_matrix(moving[:, :3] - mm, fixed[:, :3] - mf, 1e-3)
    args = (S11.astype(np.float32), mf, mm)
    qk, tk, sk = TH.solve_step_transform(*map(_t, args), mode=mode,
                                         estimate_scale=estimate_scale)
    jq, jt, js = JH.solve_step_transform(*map(jnp.asarray, args), mode=mode,
                                         estimate_scale=estimate_scale)
    np.testing.assert_allclose(qk.numpy(), np.asarray(jq), **TOL)
    # t_k = mean_f - s R mean_m carries ~1500 mm terms: atol at their ulp.
    np.testing.assert_allclose(tk.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(sk), float(js), **TOL)
    if q_true[3] < 0:
        q_true = -q_true
    np.testing.assert_allclose(qk.numpy(), q_true, atol=5e-4)


def test_power_picks_most_positive_eigenvalue():
    """N = diag(5, 5, 5, -15): the dominant magnitude is negative; the
    Gershgorin shift still returns the most positive eigenvalue's vector."""
    S9 = np.zeros(9, np.float32)
    S9[0] = S9[4] = S9[8] = -5.0
    q = TH.solve_rotation_power(_t(S9)).numpy()
    N = TH.build_N(_t(S9)).numpy()
    np.testing.assert_allclose(N, np.asarray(JH.build_N(jnp.asarray(S9))), **TOL)
    assert abs(q @ N @ q - np.linalg.eigvalsh(N).max()) < 1e-4


def test_degenerate_frame_returns_identity():
    """All moments zero (every pair masked): identity q, unit s, no NaN."""
    zeros3 = torch.zeros(3)
    for mode in ("power", "svd", "jacobi"):
        for est in (True, False):
            qk, tk, sk = TH.solve_step_transform(torch.zeros(11), zeros3,
                                                 zeros3, mode=mode,
                                                 estimate_scale=est)
            assert torch.isfinite(qk).all(), mode
            np.testing.assert_allclose(qk.numpy(), [0, 0, 0, 1], atol=1e-6)
            assert float(sk) == 1.0
            np.testing.assert_allclose(tk.numpy(), 0.0, atol=1e-6)


def test_sign_canonical_power():
    """w >= 0 after the power solve: the convergence angle 2*atan2(|v|, w)
    is not sign-invariant."""
    S11 = golden_s_matrix(np.eye(3) * 2.0, -np.eye(3) * 3.0, 1.0)
    q = TH.solve_rotation_power(_t(S11[:9]))
    assert float(q[3]) >= 0.0
