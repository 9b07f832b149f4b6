"""``icp_tpu_torch.icp.pyramid`` against ``icp_tpu.icp.pyramid``: the grid
subsample bitwise, the level configs equal, and the coarse-to-fine
registration of the JAX test's small-motion rendered pair
(tests/test_pyramid.py, with PLANE) within the slice tolerances of
tests/test_torch_slice.py: ``k`` of the finest level equal, t within
0.01 mm, the angle between the rotations within 2e-4 deg, the scale within
1e-5 (after convergence each float32 step moves t by up to ~0.01 mm, so
the last 0.01 mm depends on summation order). Torch is pinned to one
thread. The JAX tests' POINT pairs, small and large motion, are held to
those tests' own bounds against the ground truth.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp import pyramid as JP
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu.sensors import synthetic
from icp_tpu_torch.icp import pyramid as TP
from tests.utils import make_cloud8


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_subsample_grid_bitwise(stride):
    lms = make_cloud8(np.random.default_rng(0), 128 * 128)
    want = np.asarray(JP.subsample_grid(jnp.asarray(lms), stride))
    got = TP.subsample_grid(torch.from_numpy(lms), stride).numpy()
    assert got.shape == ((128 // stride) ** 2, 8) and np.array_equal(got, want)


def test_subsample_grid_rejects_a_stride_off_the_grid():
    with pytest.raises(ValueError):
        TP.subsample_grid(torch.zeros((128 * 128, 8)), 3)
    with pytest.raises(ValueError):
        TP._level_config(icp_tpu_torch.ICPConfig(), 3)


@pytest.mark.parametrize("n_r", [256, 64, 16])
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_level_config_matches_jax(n_r, stride):
    jc = JP._level_config(icp_tpu.ICPConfig(n_r=n_r, estimate_scale=False), stride)
    tc = TP._level_config(icp_tpu_torch.ICPConfig(n_r=n_r, estimate_scale=False), stride)
    for f in ("m", "n_r", "bin_capacity", "query_capacity", "estimate_scale",
              "max_iterations"):
        assert getattr(tc, f) == getattr(jc, f), f


def _rendered(theta, t):
    """Landmarks of the reference renderer's scene from the identity and
    from a pose turned by theta about y and moved by t, as numpy arrays."""
    scene = synthetic.default_scene()
    q = np.array([0, np.sin(theta / 2), 0, np.cos(theta / 2)], np.float32)
    pose_b = synthetic.CameraPose(jnp.asarray(q), jnp.asarray(np.float32(t)))
    return tuple(np.array(get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8)))
                 for p in (synthetic.CameraPose.identity(), pose_b))


def test_register_pyramid_matches_jax_on_small_motion(one_thread):
    """The JAX test's small-motion pair with the PLANE objective, which
    converges at every level in both packages. (With POINT, the finest
    level of this rendered pair sits on its landmark-lattice floor and
    both packages run to the cap of 40 in steps of ~0.7 mm, so the last
    iterate is no converged state to compare at 0.01 mm: the next test
    holds POINT to the JAX test's own bounds.)"""
    la, lb = _rendered(0.004, [5.0, -3.0, 4.0])  # the JAX test's pair
    js = JP.register_pyramid(jnp.asarray(la), jnp.asarray(lb),
                             icp_tpu.ICPParams(alpha=2e2).as_f32(),
                             icp_tpu.ICPConfig(objective=icp_tpu.Objective.PLANE,
                                               estimate_scale=False))
    ts = TP.register_pyramid(torch.from_numpy(la), torch.from_numpy(lb),
                             icp_tpu_torch.ICPParams(alpha=2e2),
                             icp_tpu_torch.ICPConfig(objective=icp_tpu_torch.Objective.PLANE,
                                                     estimate_scale=False))
    assert int(ts.k) == int(js.k)
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 2e-4
    assert abs(float(ts.s) - float(js.s)) <= 1e-5


def _errors(state, rel):
    t = np.linalg.norm(state.t.numpy() - np.asarray(rel.t))
    return t, float(qangle_deg(qmul(jnp.asarray(state.q.numpy()), qconj(rel.q))))


@pytest.mark.parametrize("theta, t, large", [(0.004, [5.0, -3.0, 4.0], False),
                                             (0.02, [60.0, -30.0, 40.0], True)])
def test_register_pyramid_meets_the_jax_tests_bounds(theta, t, large):
    """The JAX tests' POINT pairs (tests/test_pyramid.py) against the ground
    truth, with their bounds: on small motion the pyramid is no more than
    1 mm worse than one level; on large motion (outside one level's basin)
    it lands within 10 mm and 0.3 deg and no more than 1 mm worse."""
    from icp_tpu.slam import se3

    la, lb = (torch.from_numpy(x) for x in _rendered(theta, t))
    q = np.array([0, np.sin(theta / 2), 0, np.cos(theta / 2)], np.float32)
    rel = se3.relative(synthetic.CameraPose.identity(),
                       synthetic.CameraPose(jnp.asarray(q), jnp.asarray(np.float32(t))))
    params = icp_tpu_torch.ICPParams(alpha=2e2)
    config = icp_tpu_torch.ICPConfig(estimate_scale=False, max_iterations=40)
    t_single, _ = _errors(icp_tpu_torch.register(la, lb, params, config), rel)
    t_pyr, a_pyr = _errors(TP.register_pyramid(la, lb, params, config, strides=(4, 2, 1)), rel)
    assert t_pyr <= t_single + 1.0, (t_pyr, t_single)
    if large:
        assert t_pyr < 10.0 and a_pyr < 0.3, (t_pyr, a_pyr)


def test_register_pyramid_levels_are_warm_started_registrations(one_thread):
    """The pyramid is icp_run level by level, each warm-started from the
    last with k reset: the same as calling the levels by hand, bitwise."""
    from icp_tpu_torch.icp.run import build_target, icp_run
    from icp_tpu_torch.icp.state import identity_state

    la, lb = (torch.from_numpy(x) for x in _rendered(0.004, [5.0, -3.0, 4.0]))
    params = icp_tpu_torch.ICPParams(alpha=2e2)
    config = icp_tpu_torch.ICPConfig(estimate_scale=False)
    got = TP.register_pyramid(la, lb, params, config, strides=(4, 2))
    state = identity_state()
    for stride in (4, 2):
        cfg = TP._level_config(config, stride)
        state = dataclasses.replace(state, k=torch.zeros((), dtype=torch.int32))
        f = TP.subsample_grid(la, stride).contiguous()
        state = icp_run(TP.subsample_grid(lb, stride).contiguous(),
                        build_target(f, params.to("cpu"), cfg), params, cfg, init=state)
    for name in ("q", "t", "s", "qk", "tk", "sk", "k"):
        assert torch.equal(getattr(got, name), getattr(state, name)), name
