"""The flat-wall regime (tests/test_wall.py) through ``icp_tpu.register``
and ``icp_tpu_torch.register`` on the same landmarks, and the bench's
``wall`` pair (bench.py:352-391) at a cut iteration budget.

On a frontal wall the geometry is degenerate and the photometric term
carries the in-plane motion. Each package must meet tests/test_wall.py's
own bounds, and the two must agree within the slice tolerances of
tests/test_torch_slice.py: ``k`` equal, t within 0.01 mm, the angle
between the rotations within 2e-4 deg; torch pinned to one thread. The
landmarks are made once by the JAX package's renderer (its test's
textured wall) and handed to both as numpy arrays. The bench's pair runs
at ``max_iterations`` 8 here, where both packages stop at the cap; the
full gate (60 iterations, lateral error < 6 mm at alpha 4e5 and > 25 mm at
alpha 1e-6) is held on the card by ``chip_smoke.py``.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu.sensors import realdata, synthetic
from icp_tpu.slam import se3
from tests.test_wall import _wall_cloud

T_TOL, A_TOL = 0.01, 2e-4  # mm, deg: the slice tolerances


def _landmarks(pose):
    return np.array(get_landmarks(_wall_cloud(pose).reshape(-1, 8)))


def _both(la, lb, alpha, objective, max_iterations):
    """(JAX state, port state) of the same registration."""
    jcfg = icp_tpu.ICPConfig(estimate_scale=False, max_iterations=max_iterations,
                             objective=icp_tpu.Objective(objective))
    tcfg = icp_tpu_torch.ICPConfig(estimate_scale=False, max_iterations=max_iterations,
                                   objective=icp_tpu_torch.Objective(objective))
    js = icp_tpu.register(jnp.asarray(la), jnp.asarray(lb),
                          icp_tpu.ICPParams(alpha=alpha).as_f32(), jcfg)
    ts = icp_tpu_torch.register(torch.from_numpy(la), torch.from_numpy(lb),
                                icp_tpu_torch.ICPParams(alpha=alpha), tcfg)
    return js, ts


def _agree(js, ts):
    assert int(ts.k) == int(js.k)
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), rtol=0, atol=T_TOL)
    dang = float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q))))
    assert dang < A_TOL, dang


def _wall_bounds(st, rel):
    """tests/test_wall.py's POINT bounds on a state (q, t as numpy)."""
    q, t = np.asarray(st[0]), np.asarray(st[1])
    assert float(qangle_deg(qmul(jnp.asarray(q), qconj(rel.q)))) < 0.01
    assert abs(float(t[2]) - float(rel.t[2])) < 0.5  # normal direction
    lateral = np.linalg.norm(t[:2] - np.asarray(rel.t[:2]))
    assert lateral < 30.0, lateral


def test_wall_point_matches_jax_and_bounds():
    """POINT at alpha 1e3, 60 iterations: the wall normal and the rotation
    exact, the in-plane drift bounded, in both packages; they agree."""
    A = synthetic.CameraPose.identity()
    th = 0.006
    q = np.array([0, np.sin(th / 2), 0, np.cos(th / 2)], np.float32)
    B = synthetic.CameraPose(jnp.asarray(q), jnp.asarray(np.float32([10.0, -5.0, 4.0])))
    rel = se3.relative(A, B)
    js, ts = _both(_landmarks(A), _landmarks(B), 1e3, "point", 60)
    _wall_bounds((js.q, js.t), rel)
    _wall_bounds((ts.q.numpy(), ts.t.numpy()), rel)
    _agree(js, ts)


def test_wall_plane_matches_jax_and_bounds():
    """PLANE at alpha 1e3: the normal direction to 0.05 mm and the
    rotation to 0.01 deg in both packages; they agree."""
    A = synthetic.CameraPose.identity()
    B = synthetic.CameraPose(jnp.asarray(np.float32([0, 0, 0, 1])),
                             jnp.asarray(np.float32([4.0, -2.0, 5.0])))
    js, ts = _both(_landmarks(A), _landmarks(B), 1e3, "plane", 60)
    for st in (js, ts):
        t, q = np.asarray(st.t), np.asarray(st.q)
        assert abs(float(t[2]) - 5.0) < 0.05
        assert float(qangle_deg(jnp.asarray(q))) < 0.01
    _agree(js, ts)


@pytest.fixture(scope="module")
def bench_wall():
    """The bench's wall pair: the real wall surface observed from the
    identity and from an in-plane motion of (30, -15, 4) mm."""
    wpts, wrgb = realdata.wall_surface()
    id_q = np.array([0, 0, 0, 1], np.float32)
    wt = np.array([30.0, -15.0, 4.0], np.float32)
    la, lb = (np.array(get_landmarks(jnp.asarray(
        realdata.observe(wpts, wrgb, id_q, t).reshape(-1, 8)))) for t in
        (np.zeros(3, np.float32), wt))
    return la, lb, wt


@pytest.mark.parametrize("alpha", [4e5, 1e-6])
def test_bench_wall_pair_at_eight_iterations(bench_wall, alpha):
    """Both blends of the bench's gate (colour carrying the in-plane
    motion, and geometry alone) run the same 8 steps in both packages."""
    la, lb, wt = bench_wall
    js, ts = _both(la, lb, alpha, "point", 8)
    _agree(js, ts)
    # The normal direction is exact either way (bench.py's z bound).
    assert abs(float(ts.t[2]) - float(wt[2])) < 0.5
