"""Slice 2 as a whole: ``icp_tpu_torch.register`` against ``icp_tpu.register``
for the PLANE, symmetric PLANE, GICP and robust bench gates, on the
reference's rendered gate pair cut to a 64 x 64 organized grid; the moving
normals of the loop; and the loop against the step-by-step loop."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu.sensors import synthetic
from icp_tpu_torch.icp import run as TRUN
from icp_tpu_torch.icp import step as TSTEP
from icp_tpu_torch.icp.state import identity_state
from icp_tpu_torch.interop import config_from_dict
from icp_tpu_torch.ops.normals import grid_normals

# bench.py's gate pair: pose A the identity, pose B 0.008 rad about y and
# t = (10, -6, 8) mm, so B is the ground truth.
Q_GT = np.array([0.0, np.sin(0.004), 0.0, np.cos(0.004)], np.float32)
T_GT = np.array([10.0, -6.0, 8.0], np.float32)
SIDE = 64  # landmarks[::2, ::2]: m = 4096
N_R = 64

GATES = {
    "plane": {"objective": "plane"},
    "plane_sym": {"objective": "plane", "plane_symmetric": True},
    "gicp": {"objective": "gicp"},
    "robust": {"objective": "plane", "weighting": "regular", "robust": "trimmed",
               "robust_adaptive": True},
    "plane_grid": {"objective": "plane", "normal_mode": "grid"},
}
_J_ENUMS = {"objective": icp_tpu.Objective, "weighting": icp_tpu.Weighting,
            "robust": icp_tpu.RobustKernel}


@pytest.fixture(scope="module")
def pair():
    """(fixed, moving, moving with 12 % gross outliers) landmarks of the
    gate pair at 64 x 64, the outliers made as bench.py makes them."""
    scene = synthetic.default_scene()
    pose_b = synthetic.CameraPose(jnp.asarray(Q_GT), jnp.asarray(T_GT))
    lms = []
    for pose in (synthetic.CameraPose.identity(), pose_b):
        full = np.asarray(get_landmarks(
            synthetic.render_cloud(scene, pose).reshape(-1, 8)))
        lms.append(full.reshape(128, 128, 8)[::2, ::2].reshape(-1, 8).copy())
    fixed, moving = lms
    rng = np.random.default_rng(5)
    dirty = moving.copy()
    idx = rng.choice(len(dirty), len(dirty) // 8, replace=False)
    dirty[idx, :3] += (rng.uniform(250, 500, (len(idx), 3))
                       * rng.choice([-1.0, 1.0], (len(idx), 3))).astype(np.float32)
    return fixed, moving, dirty


def _errors(t, q):
    t_err = float(np.linalg.norm(np.asarray(t, np.float64) - T_GT))
    a_err = float(qangle_deg(qmul(jnp.asarray(q), qconj(jnp.asarray(Q_GT)))))
    return t_err, a_err


@pytest.mark.parametrize("gate", list(GATES))
def test_register_matches_jax_on_rendered_gate(pair, gate):
    """Equal k, |dt| <= 0.01 mm and <= 1e-3 deg between the port and the
    reference. At this cut (a quarter of the bench's landmarks) the
    reference itself misses the bench's 0.05 deg bound on PLANE and
    symmetric PLANE (0.066 deg, t_err 0.46 / 0.49 mm, JAX 0.9.0 on the CPU),
    so the port is held to the reference's own errors: within 0.01 mm and
    1e-3 deg of them, and under the 1.0 mm bound."""
    fixed, moving, dirty = pair
    mv = dirty if gate == "robust" else moving
    d = dict(GATES[gate], m=SIDE * SIDE, n_r=N_R, estimate_scale=False)
    jcfg = icp_tpu.ICPConfig(**{k: _J_ENUMS[k](v) if k in _J_ENUMS else v
                                for k, v in d.items()})
    js = icp_tpu.register(jnp.asarray(fixed), jnp.asarray(mv),
                          icp_tpu.ICPParams(alpha=2e2).as_f32(), jcfg)
    ts = icp_tpu_torch.register(torch.from_numpy(fixed), torch.from_numpy(mv),
                                icp_tpu_torch.ICPParams(alpha=2e2),
                                config_from_dict(d))
    assert int(ts.k) == int(js.k)
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 1e-3
    assert float(ts.s) == 1.0
    jt, ja = _errors(js.t, js.q)
    tt, ta = _errors(ts.t.numpy(), ts.q.numpy())
    assert tt < 1.0
    assert tt <= jt + 0.01 and ta <= ja + 1e-3


def test_build_index_carries_grid_normals(pair):
    fixed = torch.from_numpy(pair[0])
    params = icp_tpu_torch.ICPParams(alpha=2e2).to("cpu")
    cfg = config_from_dict(dict(GATES["plane"], m=SIDE * SIDE, n_r=N_R))
    index = TRUN.build_index(fixed, params, cfg)
    assert torch.equal(index.normals, grid_normals(fixed, SIDE))
    assert index.bins_vals12.shape == (N_R, cfg.bin_capacity, 12)
    assert index.gn_w.shape == (N_R, 8, 8, 64)
    point = TRUN.build_index(fixed, params, config_from_dict(
        dict(m=SIDE * SIDE, n_r=N_R)))
    assert point.normals is None and point.bins_vals12 is None and point.gn_w is None


def test_icp_run_estimates_moving_normals_once(pair, monkeypatch):
    """``icp_run`` computes the moving normals once per registration and
    hands them to every step; the step never estimates its own."""
    calls = {"run": 0, "step": 0}
    real = TRUN.normals_for

    def counting(where):
        def f(*a, **k):
            calls[where] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(TRUN, "normals_for", counting("run"))
    monkeypatch.setattr(TSTEP, "normals_for", counting("step"))
    fixed, moving, _ = map(torch.from_numpy, pair)
    params = icp_tpu_torch.ICPParams(alpha=2e2).to("cpu")
    cfg = config_from_dict(dict(GATES["gicp"], m=SIDE * SIDE, n_r=N_R,
                                estimate_scale=False, max_iterations=3))
    index = TRUN.build_index(fixed, params, cfg)  # the fixed side: 1 call
    st = TRUN.icp_run(moving, index, params, cfg)
    assert int(st.k) == 3
    assert calls == {"run": 2, "step": 0}


def test_icp_step_moving_normals_given_equals_computed(pair):
    fixed, moving, _ = map(torch.from_numpy, pair)
    params = icp_tpu_torch.ICPParams(alpha=2e2).to("cpu")
    cfg = config_from_dict(dict(GATES["plane_sym"], m=SIDE * SIDE, n_r=N_R,
                                estimate_scale=False))
    index = TRUN.build_index(fixed, params, cfg)
    st = identity_state()
    a = TSTEP.icp_step(st, moving, index, params, cfg)
    b = TSTEP.icp_step(st, moving, index, params, cfg,
                       moving_normals=grid_normals(moving, SIDE))
    for name in ("q", "t", "qk", "tk"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _step_by_step(moving, index, params, config):
    state = identity_state()
    mn = TRUN.normals_for(moving, config.normal_mode)
    done = False
    while state.k < config.max_iterations and (state.k == 0 or not done):
        state = TSTEP.icp_step(state, moving, index, params, config,
                               moving_normals=mn)
        done = bool(TRUN.converged(state, params))
    return state


@pytest.mark.parametrize("gate, max_iterations, thresholds", [
    ("gicp", 40, (0.001, 0.01)),
    ("robust", 5, (0.0, 0.0)),
    ("plane_sym", 9, (0.0, 0.0)),
])
def test_chunked_loop_equals_step_by_step(pair, gate, max_iterations, thresholds):
    fixed, moving, dirty = map(torch.from_numpy, pair)
    mv = dirty if gate == "robust" else moving
    params = icp_tpu_torch.ICPParams(alpha=2e2, angle_threshold_deg=thresholds[0],
                                     translation_threshold=thresholds[1]).to("cpu")
    cfg = config_from_dict(dict(GATES[gate], m=SIDE * SIDE, n_r=N_R,
                                estimate_scale=False, max_iterations=max_iterations))
    index = TRUN.build_index(fixed, params, cfg)
    want = _step_by_step(mv, index, params, cfg)
    got = TRUN.icp_run(mv, index, params, cfg)
    for name in ("q", "t", "s", "qk", "tk", "sk", "k"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if thresholds[0] == 0.0:
        assert int(got.k) == max_iterations
