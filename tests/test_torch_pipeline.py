"""``icp_tpu_torch.icp.pipeline`` (ICPSBS / ICPReg) against
``icp_tpu.icp.pipeline`` on the JAX test's rendered 640x480 pair
(tests/test_pipeline.py), made by the JAX package's renderer and handed to
both as numpy arrays.

Tolerances: the slice tolerances of tests/test_torch_slice.py (``k``
equal, t within 0.01 mm, the angle between the rotations within 2e-4 deg,
the scale within 1e-5), torch pinned to one thread. The PLANE objective
is compared over two steps and over the whole registration. The default
POINT objective is compared at step 1 on each package's own search target,
and over steps 1 and 2 on JAX's target carried across: on this rendered
lattice two of the 16384 fixed landmarks lie at a tie between two
representatives, which the port's float32 distance expansion breaks one
way and JAX's jitted one the other (JAX's own eager expansion breaks them
the port's way), so the two targets put them in different bins, and from
step 2 on that moves the POINT estimate by up to 3.2e-4 deg. :func:`test_targets_differ_only_at_representative_ties` holds
that claim. POINT's whole registration runs to the cap of 40 in both
packages and is held to the JAX test's own bounds (1 <= k <= 40,
|t| < 50 mm, angle < 2 deg).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp import pipeline as JPIPE
from icp_tpu.icp import run as JRUN
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.sensors import synthetic
from icp_tpu.ops.distance import pairwise_sq_dists as j_pairwise_sq_dists
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu_torch.icp import pipeline as TPIPE
from icp_tpu_torch.interop import index_from_numpy
from icp_tpu_torch.ops.distance import pairwise_sq_dists

FIELDS = ["Iteration k", "Latency", "Rotation angle", "Rotation axis",
          "Translation vector", "Scale", "Change in translation", "Change in rotation"]


@pytest.fixture(scope="module")
def clouds():
    """The JAX test's pair: the default scene from the identity and from a
    pose turned by 0.006 rad about y and moved by (8, -4, 6) mm."""
    scene = synthetic.default_scene()
    q = np.array([0, np.sin(0.003), 0, np.cos(0.003)], np.float32)
    pose_b = synthetic.CameraPose(jnp.asarray(q), jnp.asarray(np.float32([8.0, -4.0, 6.0])))
    return tuple(np.array(synthetic.render_cloud(scene, p))
                 for p in (synthetic.CameraPose.identity(), pose_b))


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _configs(objective):
    return (icp_tpu.ICPConfig(objective=icp_tpu.Objective(objective), estimate_scale=False),
            icp_tpu_torch.ICPConfig(objective=icp_tpu_torch.Objective(objective),
                                    estimate_scale=False))


def _assert_close(ts, js):
    assert int(ts.k) == int(js.k)
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 2e-4
    assert abs(float(ts.s) - float(js.s)) <= 1e-5


def _labels(out: str) -> list:
    """Each report line's label (the text before its colon), or the whole
    line with its numbers blanked."""
    return [line.split(":")[0].strip() if ":" in line
            else re.sub(r"\d+(\.\d+)?", "#", line) for line in out.splitlines()]


def test_step_by_step_matches_jax(clouds, one_thread, capsys):
    fixed, moving = clouds
    jc, tc = _configs("plane")
    japp = JPIPE.ICPStepByStep(fixed, moving, icp_tpu.ICPParams(alpha=2e2), jc)
    tapp = TPIPE.ICPStepByStep(torch.from_numpy(fixed), torch.from_numpy(moving),
                               icp_tpu_torch.ICPParams(alpha=2e2), tc)
    japp.build_rbc()
    tapp.build_rbc()
    for k in (1, 2):
        js = japp.step(verbose=True)
        j_out = capsys.readouterr().out
        ts = tapp.step(verbose=True)
        t_out = capsys.readouterr().out
        assert int(ts.k) == k
        _assert_close(ts, js)
        # The same report, field by field (the reference's
        # src/ocl_icp_sbs.cpp:202-217).
        assert _labels(t_out) == _labels(j_out)
        for field in FIELDS:
            assert field in t_out, field
    # The clouds' points lie within 3000 mm of the camera: t within 0.01 mm
    # and the rotation within 2e-4 deg (3.5e-6 rad) move none by more than
    # 0.02 mm. The colour half passes through bitwise.
    got, want = tapp.transformed_cloud().numpy(), np.asarray(japp.transformed_cloud())
    assert np.max(np.linalg.norm(moving.reshape(-1, 8)[:, :3], axis=1)) < 3000.0
    assert np.max(np.abs(got[:, :3] - want[:, :3])) <= 0.02
    assert np.array_equal(got[:, 3:], want[:, 3:])


def _apps(clouds, objective):
    fixed, moving = clouds
    jc, tc = _configs(objective)
    japp = JPIPE.ICPStepByStep(fixed, moving, icp_tpu.ICPParams(alpha=2e2), jc)
    tapp = TPIPE.ICPStepByStep(torch.from_numpy(fixed), torch.from_numpy(moving),
                               icp_tpu_torch.ICPParams(alpha=2e2), tc)
    japp.build_rbc()
    tapp.build_rbc()
    return japp, tapp


def test_step_by_step_point_matches_jax(clouds, one_thread):
    """POINT: step 1 on each package's own target, then steps 1 and 2 with
    JAX's target carried across to the port."""
    japp, tapp = _apps(clouds, "point")
    js1 = japp.step(verbose=False)
    _assert_close(tapp.step(verbose=False), js1)
    js2 = japp.step(verbose=False)
    tapp.reset()
    tapp._index = index_from_numpy(jax.tree.map(np.asarray, japp._index._asdict()),
                                   device="cpu")
    _assert_close(tapp.step(verbose=False), js1)
    _assert_close(tapp.step(verbose=False), js2)


def test_targets_differ_only_at_representative_ties(clouds):
    """Where the two targets put a fixed landmark in different bins, the
    landmark is at a tie between two representatives: JAX's own eager
    distances put them no further apart than the two packages' expansions
    differ anywhere, and pick the port's representative, not the one of
    JAX's jitted build. Every bin that neither tie touches holds the same
    landmarks in the same live slots in both targets."""
    japp, tapp = _apps(clouds, "point")
    jidx, tidx = japp._index, tapp._index
    reps = np.asarray(jidx.reps)
    np.testing.assert_array_equal(tidx.reps.numpy(), reps)
    rj, rt = np.asarray(jidx.rep_id), tidx.rep_id.numpy()
    moved = np.nonzero(rj != rt)[0]
    assert 0 < len(moved) <= 4
    dj = np.asarray(j_pairwise_sq_dists(japp.fixed_lms, jnp.asarray(reps), jnp.float32(2e2)))
    dt = pairwise_sq_dists(tapp.fixed_lms, tidx.reps, 2e2).numpy()
    rounding = np.max(np.abs(dj - dt))
    assert rounding <= 1e-6 * np.max(dj)
    assert np.all(np.abs(dj[moved, rj[moved]] - dj[moved, rt[moved]]) <= rounding)
    np.testing.assert_array_equal(dj[moved].argmin(1), rt[moved])
    # A touched bin at its capacity of 128 also keeps or drops another
    # landmark, so only the untouched bins are compared.
    touched = set(rj[moved].tolist()) | set(rt[moved].tolist())
    same = [r for r in range(reps.shape[0]) if r not in touched]
    live = np.isfinite(np.asarray(jidx.sq_b_masked))[same]
    np.testing.assert_array_equal(np.isfinite(tidx.sq_b_masked.numpy())[same], live)
    for f in ("bin_ids", "bins_centered"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy()[same][live],
                                      np.asarray(getattr(jidx, f))[same][live], err_msg=f)
    # |b|^2_w sums eight lanes in another order (tests/test_torch_rbc.py's
    # 1e-6 relative bound on the index's float fields).
    np.testing.assert_allclose(tidx.sq_b_masked.numpy()[same][live],
                               np.asarray(jidx.sq_b_masked)[same][live], rtol=1e-6)


def test_step_by_step_pipeline(clouds, capsys):
    """The JAX test's checks, on the default (POINT) configuration."""
    fixed, moving = clouds
    app = TPIPE.ICPStepByStep(torch.from_numpy(fixed), torch.from_numpy(moving),
                              icp_tpu_torch.ICPParams(alpha=2e2),
                              icp_tpu_torch.ICPConfig(estimate_scale=False))
    app.build_rbc()
    assert int(app.step(verbose=True).k) == 1
    out = capsys.readouterr().out
    for field in FIELDS:
        assert field in out, field
    assert int(app.step(verbose=False).k) == 2
    tc = app.transformed_cloud()
    assert tc.shape == (307200, 8)
    assert np.array_equal(tc[:, 4:].numpy(), moving.reshape(-1, 8)[:, 4:])
    app.reset()
    assert int(app.state.k) == 0


def test_step_by_step_builds_its_target_on_the_first_step():
    """Without build_rbc the first step builds the search target, as the
    reference's does (BRUTE POINT needs none and searches the landmarks)."""
    scene = synthetic.default_scene()
    cloud = np.array(synthetic.render_cloud(scene, synthetic.CameraPose.identity()))
    for corr in ("rbc", "brute"):
        cfg = icp_tpu_torch.ICPConfig(correspondence=icp_tpu_torch.Correspondence(corr),
                                      estimate_scale=False)
        app = TPIPE.ICPStepByStep(torch.from_numpy(cloud), torch.from_numpy(cloud),
                                  icp_tpu_torch.ICPParams(alpha=2e2), cfg)
        assert int(app.step(verbose=False).k) == 1
        assert (app._index is None) == (corr == "brute")


def test_registration_matches_jax(clouds, one_thread, capsys):
    fixed, moving = clouds
    jc, tc = _configs("plane")
    js = JPIPE.ICPRegistration(icp_tpu.ICPParams(alpha=2e2), jc).register_clouds(
        fixed, moving, verbose=True)
    j_out = capsys.readouterr().out
    ts = TPIPE.ICPRegistration(icp_tpu_torch.ICPParams(alpha=2e2), tc).register_clouds(
        torch.from_numpy(fixed), torch.from_numpy(moving), verbose=True)
    t_out = capsys.readouterr().out
    _assert_close(ts, js)
    assert _labels(t_out) == _labels(j_out)
    assert "Registration finished in k =" in t_out


def test_registration_pipeline(clouds, capsys):
    """The JAX test's checks and bounds, on the default (POINT) configuration."""
    fixed, moving = clouds
    app = TPIPE.ICPRegistration(icp_tpu_torch.ICPParams(alpha=2e2),
                                icp_tpu_torch.ICPConfig(estimate_scale=False))
    st = app.register_clouds(torch.from_numpy(fixed), torch.from_numpy(moving), verbose=True)
    assert "Registration finished in k =" in capsys.readouterr().out
    assert 1 <= int(st.k) <= 40
    assert float(torch.linalg.vector_norm(st.t)) < 50.0
    assert float(icp_tpu_torch.icp.quaternion.qangle_deg(st.q)) < 2.0


def _on_the_card(make):
    """``make()`` puts its result on the card, or raises where the card is
    missing: nothing lands on the CPU unasked."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_numpy_inputs_go_to_the_card(clouds):
    """Numpy clouds go to the card, as does an index carried across from
    numpy with the default device; a CPU tensor stays on the CPU."""
    fixed, moving = clouds
    _on_the_card(lambda: TPIPE.ICPStepByStep(fixed, moving).fixed_cloud)
    _on_the_card(lambda: TPIPE.ICPRegistration().register_clouds(fixed, moving, verbose=False).q)
    lms = np.asarray(get_landmarks(jnp.asarray(fixed).reshape(-1, 8)))
    jidx = JRUN.build_index(jnp.asarray(lms), icp_tpu.ICPParams(alpha=2e2).as_f32(),
                               icp_tpu.ICPConfig())
    _on_the_card(lambda: index_from_numpy(jax.tree.map(np.asarray, jidx._asdict())).reps)
    app = TPIPE.ICPStepByStep(torch.from_numpy(fixed), torch.from_numpy(moving))
    assert app.fixed_cloud.device.type == "cpu" and app.state.q.device.type == "cpu"
