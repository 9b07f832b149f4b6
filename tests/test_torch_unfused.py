"""The unfused per-pair pipeline of the port against icp_tpu on the same
numpy inputs: the POINT moments (centroids, S matrix), the GICP solver, one
unfused step (RBC grouped search and BRUTE) at a random accumulated state,
the port's fused step against its unfused step, and whole registrations
(BRUTE POINT on the end-to-end pair; BRUTE PLANE, unfused PLANE, symmetric
PLANE, GICP and robust TRIMMED adaptive on the rendered gate pair at 64x64).
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from __graft_entry__ import _synthetic_pair
from icp_tpu.icp import gicp as JG
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.icp.state import identity_state as j_identity
from icp_tpu.icp.step import BruteTarget as JBruteTarget
from icp_tpu.icp.step import icp_step as j_icp_step
from icp_tpu.ops import moments as JM
from icp_tpu.ops.normals import normals_for as j_normals_for
from icp_tpu.rbc.construct import rbc_construct as j_rbc_construct
from icp_tpu_torch.icp import gicp as TG
from icp_tpu_torch.icp.state import ICPState
from icp_tpu_torch.icp.step import BruteTarget, icp_step
from icp_tpu_torch.interop import config_from_dict, index_from_numpy
from icp_tpu_torch.kernels import bin_search, brute_nn  # the K5 and K6 wrappers
from icp_tpu_torch.ops import moments as TM
from tests.test_icp_e2e import _make_pair
from tests.test_torch_slice2 import GATES, N_R, SIDE, _errors, pair  # noqa: F401
from tests.utils import random_quat

ALPHA = 150.0


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---- the POINT moments and the GICP solver ---------------------------------


def _pairs(rng, n=300):
    f = np.ones((n, 8), np.float32)
    f[:, :3] = rng.normal(size=(n, 3)) * 100 + [0, 0, 1500]
    m = f.copy()
    m[:, :3] += rng.normal(size=(n, 3)) * 3
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    return f, m, w, mask


@pytest.mark.parametrize("weighted, masked", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_centroids_s_matrix_match_jax(rng, weighted, masked):
    f, m, w, mask = _pairs(rng)
    jw = jnp.asarray(w) if weighted else None
    tw = _t(w) if weighted else None
    jmask = jnp.asarray(mask) if masked else None
    tmask = _t(mask) if masked else None
    j_sum = JM.masked_weight_sum(jw, jmask) if weighted else None
    t_sum = TM.masked_weight_sum(tw, tmask) if weighted else None
    if weighted:
        np.testing.assert_allclose(float(t_sum), float(j_sum), rtol=1e-6)
    jc = JM.centroids(jnp.asarray(f), jnp.asarray(m), jw, j_sum, jmask)
    tc = TM.centroids(_t(f), _t(m), tw, t_sum, tmask)
    for g, want in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6)
    for g, want in zip(TM.centroid_partials(_t(f), _t(m), tw, tmask),
                       JM.centroid_partials(jnp.asarray(f), jnp.asarray(m), jw, jmask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5)
    jdm, jdf = JM.deviations(jnp.asarray(m), jc[1]), JM.deviations(jnp.asarray(f), jc[0])
    tdm, tdf = TM.deviations(_t(m), tc[1]), TM.deviations(_t(f), tc[0])
    np.testing.assert_allclose(tdm.numpy(), np.asarray(jdm), rtol=1e-5, atol=1e-3)
    want = np.asarray(JM.s_matrix(jdm, jdf, 1e-3, jw, jmask))
    got = TM.s_matrix(_t(np.asarray(jdm)), _t(np.asarray(jdf)), 1e-3, tw, tmask).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_centroids_fully_masked_frame_stays_finite(rng):
    f, m, w, _ = _pairs(rng)
    mask = torch.zeros(len(w), dtype=torch.bool)
    s = TM.masked_weight_sum(_t(w), mask)
    assert float(s) == 0.0
    for c in TM.centroids(_t(f), _t(m), _t(w), s, mask) + TM.centroids(
            _t(f), _t(m), None, None, mask):
        assert torch.isfinite(c).all()


def test_gicp_solver_matches_jax(rng):
    f, m, w, mask = _pairs(rng)
    nf = rng.normal(size=(len(f), 3)).astype(np.float32)
    nf /= np.linalg.norm(nf, axis=1, keepdims=True)
    nm = nf + rng.normal(size=nf.shape).astype(np.float32) * 0.1
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    nf[:10] = 0.0  # zero normals: isotropic
    M = np.asarray(JG.disk_covariance_sum(jnp.asarray(nf), jnp.asarray(nm), 1e-3))
    np.testing.assert_allclose(TG.disk_covariance_sum(_t(nf), _t(nm), 1e-3).numpy(),
                               M, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TG.inv3x3(_t(M)).numpy(),
                               np.asarray(JG.inv3x3(jnp.asarray(M))), rtol=1e-4, atol=1e-4)
    args = (f[:, :3], m[:, :3], nf, nm)
    for weights, msk in ((w, mask), (None, None)):
        jH, jb = JG.gicp_system_partials(*map(jnp.asarray, args), 1e-3,
                                         None if weights is None else jnp.asarray(weights),
                                         None if msk is None else jnp.asarray(msk))
        H, b = TG.gicp_system_partials(*map(_t, args), 1e-3,
                                       None if weights is None else _t(weights),
                                       None if msk is None else _t(msk))
        np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(jH)).max())
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(jb)).max())
    jq, jt = JG.solve_gicp(*map(jnp.asarray, args), 1e-3, jnp.asarray(w), jnp.asarray(mask))
    q, t = TG.solve_gicp(*map(_t, args), 1e-3, _t(w), _t(mask))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6)
    # The float32 6x6 solve of sums taken in another order: ~3e-5 relative.
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)


# ---- one unfused step at a random accumulated state -------------------------


@pytest.fixture(scope="module")
def scene():
    """The benchmark's surface pair (m 2048) with kNN normals computed by
    the JAX package as data, a JAX RBC index with those normals, the same
    index in the port, and a random accumulated state."""
    rng = np.random.default_rng(7)
    fixed, moving = _synthetic_pair(2048, seed=4)
    fixed[5:12] = 0.0
    moving[20:26] = 0.0
    fn = np.asarray(j_normals_for(jnp.asarray(fixed), "knn"))
    mn = np.asarray(j_normals_for(jnp.asarray(moving), "knn"))
    reps = fixed[rng.choice(np.arange(20, 2048), 32, replace=False)]
    jidx = j_rbc_construct(jnp.asarray(fixed), jnp.asarray(reps), jnp.float32(ALPHA),
                           128, normals=jnp.asarray(fn))
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu")
    q = random_quat(rng, 0.02)
    t = (rng.normal(size=3) * 5).astype(np.float32)
    return dict(fixed=fixed, moving=moving, fn=fn, mn=mn, jidx=jidx, tidx=tidx,
                q=q, t=t)


STEP_CASES = {
    "point": {},
    "point_huber_adaptive": {"robust": "huber", "robust_adaptive": True},
    "point_brute_regular": {"correspondence": "brute", "weighting": "regular"},
    "plane": {"objective": "plane"},
    "plane_sym_regular": {"objective": "plane", "plane_symmetric": True,
                          "weighting": "regular"},
    "gicp": {"objective": "gicp"},
    "plane_trimmed_adaptive": {"objective": "plane", "weighting": "regular",
                               "robust": "trimmed", "robust_adaptive": True},
    "plane_brute": {"objective": "plane", "correspondence": "brute"},
    "gicp_brute": {"objective": "gicp", "correspondence": "brute"},
}
_J_ENUMS = {"objective": icp_tpu.Objective, "weighting": icp_tpu.Weighting,
            "robust": icp_tpu.RobustKernel, "correspondence": icp_tpu.Correspondence}


def _configs(case, **extra):
    d = dict(STEP_CASES[case], m=2048, n_r=32, query_capacity=96,
             fused_point=False, fused_gn=False, **extra)
    if d.get("objective", "point") != "point":
        d["estimate_scale"] = False
    jc = icp_tpu.ICPConfig(use_pallas=False, **{
        k: _J_ENUMS[k](v) if k in _J_ENUMS else v for k, v in d.items()})
    return jc, config_from_dict(d)


def _targets(sc, jc):
    if jc.correspondence is icp_tpu.Correspondence.RBC:
        return sc["jidx"], sc["tidx"]
    if jc.needs_normals:
        return (JBruteTarget(jnp.asarray(sc["fixed"]), jnp.asarray(sc["fn"])),
                BruteTarget(_t(sc["fixed"]), _t(sc["fn"])))
    return jnp.asarray(sc["fixed"]), _t(sc["fixed"])


def _t_state(sc):
    st = icp_tpu_torch.identity_state()
    return dataclasses.replace(st, q=_t(sc["q"]), t=_t(sc["t"]))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_unfused_step_matches_jax(scene, case):
    """One unfused step against JAX's. POINT: q within 1e-5; GN: qk within
    1e-5 and tk within 0.05 (test_fused_gn.py's bounds). Measured gap (JAX
    0.9.0 and torch on the CPU, all nine cases): q / qk <= 6e-8, tk <=
    2.5e-4 mm (the adaptive Huber case; the others <= 6e-5 mm)."""
    sc = scene
    jc, tc = _configs(case)
    jt, tt = _targets(sc, jc)
    js = j_identity()._replace(q=jnp.asarray(sc["q"]), t=jnp.asarray(sc["t"]))
    jparams = icp_tpu.ICPParams(alpha=ALPHA).as_f32()
    tparams = icp_tpu_torch.ICPParams(alpha=ALPHA).to("cpu")
    want = j_icp_step(js, jnp.asarray(sc["moving"]), jt, jparams, jc,
                      moving_normals=jnp.asarray(sc["mn"]))
    got = icp_step(_t_state(sc), _t(sc["moving"]), tt, tparams, tc,
                   moving_normals=_t(sc["mn"]))
    for name in ("q", "qk"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got.tk.numpy(), np.asarray(want.tk), atol=0.05)
    np.testing.assert_allclose(float(got.sk), float(want.sk), rtol=1e-5)
    assert int(got.k) == 1
    assert bin_search.launches == 0 and brute_nn.launches == 0


@pytest.mark.parametrize("case", ["point", "point_huber_adaptive", "plane",
                                  "plane_sym_regular", "gicp",
                                  "plane_trimmed_adaptive"])
def test_fused_step_matches_unfused(scene, case):
    """The port's fused step (K3 / K7 twins) against its unfused step (K5
    twin + per-pair tail) at the same bounds. The adaptive cases differ a
    little more: the fused median sees only the queries that hold a slot."""
    sc = scene
    _, unfused = _configs(case)
    fused = dataclasses.replace(unfused, fused_point=True, fused_gn=True)
    tparams = icp_tpu_torch.ICPParams(alpha=ALPHA).to("cpu")
    a = icp_step(_t_state(sc), _t(sc["moving"]), sc["tidx"], tparams, fused,
                 moving_normals=_t(sc["mn"]))
    b = icp_step(_t_state(sc), _t(sc["moving"]), sc["tidx"], tparams, unfused,
                 moving_normals=_t(sc["mn"]))
    np.testing.assert_allclose(a.qk.numpy(), b.qk.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.tk.numpy(), b.tk.numpy(), atol=0.05)


def test_icp_step_rejects_wrong_target(scene):
    _, tc = _configs("plane_brute")
    tparams = icp_tpu_torch.ICPParams(alpha=ALPHA).to("cpu")
    with pytest.raises(TypeError):
        icp_step(_t_state(scene), _t(scene["moving"]), _t(scene["fixed"]), tparams, tc)
    _, tc = _configs("point")
    with pytest.raises(TypeError):
        icp_step(_t_state(scene), _t(scene["moving"]), _t(scene["fixed"]), tparams, tc)


# ---- whole registrations against icp_tpu.register ---------------------------


def _assert_registrations_agree(js, ts):
    """k equal, |dt| <= 0.01 mm and <= 1e-3 deg (test_torch_slice2.py)."""
    assert int(ts.k) == int(js.k)
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 1e-3


def test_register_brute_point_matches_jax(rng):
    """The e2e pair of tests/test_icp_e2e.py at m=1024 (BRUTE, POWER,
    WEIGHTED); both land on its ground truth."""
    fixed, moving, q_true, t_true = _make_pair(rng, 1024)
    d = dict(m=1024, n_r=16, correspondence="brute", max_iterations=40)
    js = icp_tpu.register(jnp.asarray(fixed), jnp.asarray(moving),
                          icp_tpu.ICPParams().as_f32(),
                          icp_tpu.ICPConfig(m=1024, n_r=16, max_iterations=40,
                                            correspondence=icp_tpu.Correspondence.BRUTE))
    ts = icp_tpu_torch.register(_t(fixed), _t(moving), icp_tpu_torch.ICPParams(),
                                config_from_dict(d))
    _assert_registrations_agree(js, ts)
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(jnp.asarray(q_true))))) < 0.1
    np.testing.assert_allclose(ts.t.numpy(), t_true, atol=1.0)
    assert brute_nn.launches == 0


UNFUSED_GATES = {
    "plane_brute": dict(GATES["plane"], correspondence="brute"),
    "plane": dict(GATES["plane"], fused_gn=False),
    "plane_sym": dict(GATES["plane_sym"], fused_gn=False),
    "gicp": dict(GATES["gicp"], fused_gn=False),
    "robust": dict(GATES["robust"], fused_gn=False),
}


@pytest.mark.parametrize("gate", list(UNFUSED_GATES))
def test_register_unfused_gate_matches_jax(pair, gate):  # noqa: F811
    """The rendered gate pair at 64x64 (m 4096, n_r 64), held as
    test_torch_slice2.py holds the fused gates: equal k, 0.01 mm and 1e-3
    deg from the reference, and within 0.01 mm / 1e-3 deg of the
    reference's own errors under the 1.0 mm bound."""
    fixed, moving, dirty = pair
    mv = dirty if gate == "robust" else moving
    d = dict(UNFUSED_GATES[gate], m=SIDE * SIDE, n_r=N_R, estimate_scale=False)
    jcfg = icp_tpu.ICPConfig(**{k: _J_ENUMS[k](v) if k in _J_ENUMS else v
                                for k, v in d.items()})
    js = icp_tpu.register(jnp.asarray(fixed), jnp.asarray(mv),
                          icp_tpu.ICPParams(alpha=2e2).as_f32(), jcfg)
    ts = icp_tpu_torch.register(_t(fixed), _t(mv), icp_tpu_torch.ICPParams(alpha=2e2),
                                config_from_dict(d))
    _assert_registrations_agree(js, ts)
    assert float(ts.s) == 1.0
    jt, ja = _errors(js.t, js.q)
    tt, ta = _errors(ts.t.numpy(), ts.q.numpy())
    assert tt < 1.0
    assert tt <= jt + 0.01 and ta <= ja + 1e-3


def test_register_builds_the_configured_target(pair):
    """BRUTE POINT searches the bare fixed set, BRUTE PLANE a BruteTarget
    with the fixed normals, RBC an index (run.py:127-139 of the JAX
    package)."""
    fixed = _t(pair[0])
    params = icp_tpu_torch.ICPParams(alpha=2e2).to("cpu")
    base = dict(m=SIDE * SIDE, n_r=N_R)
    t = icp_tpu_torch.build_target(fixed, params, config_from_dict(
        dict(base, correspondence="brute")))
    assert t is fixed
    t = icp_tpu_torch.build_target(fixed, params, config_from_dict(
        dict(base, correspondence="brute", objective="plane")))
    assert isinstance(t, BruteTarget) and t.normals.shape == (SIDE * SIDE, 3)
    t = icp_tpu_torch.build_target(fixed, params, config_from_dict(
        dict(base, fused_point=False)))
    assert isinstance(t, icp_tpu_torch.RBCIndex)


def test_state_is_the_port_state():
    assert isinstance(icp_tpu_torch.identity_state(), ICPState)
