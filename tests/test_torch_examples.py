"""The port's reference apps (``icp_tpu_torch.examples``: frame_grabber,
registration, step_by_step) against the JAX package's ``examples/`` on the
same inputs, and the package exports this slice adds.

Each JAX example's ``main`` reads ``sys.argv``; the port's takes ``argv``
and runs on the CPU here through its ``device`` argument (on the card by
default). The clouds are the examples' own 640x480 frames at full width
(16384 landmarks, n_r 256).

Inputs: ``frame_grabber`` writes the JAX package's pair (pose A the
identity, pose B 0.008 rad about y and t = (10, -6, 8) mm, and B again
guided-filtered) and the port's; each package's reader reads all of them.
``registration`` runs on the JAX-written pair in both packages,
``step_by_step --synthetic`` on the pair the JAX
renderer makes: the port's renderer is swapped for JAX's in that test, so
both packages start from the same clouds.

Tolerances: the grabbed clouds within tests/test_torch_normals.py's render
bounds (identical hit masks, depth and x, y within 1e-4 relative and
1e-3 mm, colour within 1e-3, at most 10 silhouette pixels where the
renderers pick different surfaces), the filtered one within those plus
tests/test_torch_sensors.py's filter bounds (0.05 mm, 1e-4). The states
within the larger of the slice's tolerances (t 0.01 mm, angle 2e-4 deg,
scale 1e-5) and four times the reference's own spread, the JAX run with
the moving cloud moved one float32 ulp up, then down (the rule of
tests/test_torch_parallel.py): POINT on a rendered lattice lies at that
floor, JAX's own one-ulp spread there being ~2.7e-4 deg. Registrations
converge in k within 2 of each other, below the cap, and within 10 mm and
0.3 deg of the grabber's pose (POINT's ~3 mm landmark-lattice floor).
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import contextlib
import importlib
import inspect
import io
import os
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp import pipeline as JPIPE
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.runtime import native as JNAT
from icp_tpu.sensors import synthetic as JY
from icp_tpu_torch.examples import frame_grabber as TFG
from icp_tpu_torch.examples import registration as TREG
from icp_tpu_torch.examples import step_by_step as TSBS
from icp_tpu_torch.runtime import native as TNAT
from icp_tpu_torch.sensors import synthetic as TY

import examples.frame_grabber as JFG
import examples.registration as JREG
import examples.step_by_step as JSBS

POSE_B = ["10", "-6", "8", "0.008"]
Q_B = np.array([0.0, np.sin(0.004), 0.0, np.cos(0.004)])
T_B = np.array([10.0, -6.0, 8.0])
GRABS = {"1": [], "2": ["--pose", *POSE_B], "3": ["--pose", *POSE_B, "-f"]}
MAX_SURFACE_FLIPS = 10  # tests/test_torch_normals.py


def _jax_main(mp, module, argv):
    """A JAX example's ``main`` on ``argv``, its stdout returned."""
    mp.setattr(sys, "argv", [module.__name__ + ".py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _port_main(fn, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(argv, device="cpu", **kw)
    return ret, out.getvalue()


def _labels(out: str) -> list:
    """Each printed line's label (the text before its colon), or the line
    with its numbers and paths blanked."""
    return [line.split(":")[0].strip() if ":" in line
            else re.sub(r"\S*/\S*", "<path>", re.sub(r"\d+(\.\d+)?", "#", line))
            for line in out.splitlines()]


def _diff(a, b) -> np.ndarray:
    """(|t_a - t_b| mm, angle between q_a and q_b in deg, |s_a - s_b|)."""
    dt = np.linalg.norm(np.asarray(a.t, np.float64) - np.asarray(b.t, np.float64))
    da = float(qangle_deg(qmul(jnp.asarray(np.asarray(a.q)), qconj(jnp.asarray(np.asarray(b.q))))))
    return np.array([dt, da, abs(float(a.s) - float(b.s))])


def _assert_within_spread(got, want, run_jax, moving):
    """``got`` within max(slice tolerances, 4 x the spread of ``run_jax``
    over ``moving`` moved one float32 ulp up, then down) of ``want``."""
    spread = np.zeros(3)
    for d in (np.inf, -np.inf):
        spread = np.maximum(spread, _diff(run_jax(np.nextafter(moving, np.float32(d))), want))
    bars = np.maximum([0.01, 2e-4, 1e-5], 4 * spread)
    err = _diff(got, want)
    assert np.all(err <= bars), f"|dt|, dangle, |ds| {err}; reference spread {spread}; bars {bars}"


def _gt_errors(state) -> tuple:
    """(|t - t_B| mm, angle to q_B deg) of a registration of the grabbed pair."""
    t = np.asarray(state.t, np.float64)
    return (float(np.linalg.norm(t - T_B)),
            float(qangle_deg(qmul(jnp.asarray(np.asarray(state.q)),
                                  qconj(jnp.asarray(Q_B, jnp.float32))))))


@pytest.fixture(scope="module")
def grabbed(tmp_path_factory):
    """Both packages' frame_grabber runs (JAX's without ``-f``: XLA takes
    ~100 s on one core to compile the guided filter at 640x480): their
    directories and printed lines."""
    root = tmp_path_factory.mktemp("grab")
    printed = {"jax": {}, "torch": {}}
    with pytest.MonkeyPatch.context() as mp:
        for s in ("1", "2"):
            printed["jax"][s] = _jax_main(mp, JFG, ["-s", s, *GRABS[s], "--out-dir",
                                                    str(root / "jax")])
    for s, argv in GRABS.items():
        path, printed["torch"][s] = _port_main(TFG.main, ["-s", s, *argv, "--out-dir",
                                                          str(root / "torch")])
        assert path == str(root / "torch" / f"kg_pc8d_{s}.bin")
    return root, printed


def _read_both(path) -> np.ndarray:
    """The cloud at ``path`` as each package's reader reads it (the same)."""
    a, b = JNAT.read_cloud(path), TNAT.read_cloud(path)
    assert a.shape == (480 * 640, 8) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    return a


def test_frame_grabber_clouds_match_jax(grabbed):
    root, printed = grabbed
    for s in ("1", "2"):
        clouds = {}
        for pkg in ("jax", "torch"):
            path = str(root / pkg / f"kg_pc8d_{s}.bin")
            clouds[pkg] = _read_both(path).reshape(480, 640, 8)
            n = int((np.abs(clouds[pkg][..., :3]).sum(-1) > 0).sum())
            assert printed[pkg][s] == f"Point cloud saved in {path} ({n} valid points)\n"
        want, got = clouds["jax"], clouds["torch"]
        hit = want[..., 2] > 0
        np.testing.assert_array_equal(got[..., 2] > 0, hit)
        assert 0.5 < hit.mean() <= 1.0
        rel = np.abs(got[..., 2] - want[..., 2]) / np.maximum(want[..., 2], 1.0)
        flips = np.argwhere(rel > 1e-4)
        assert len(flips) <= MAX_SURFACE_FLIPS, f"surface flips at (v, u) {flips.tolist()}"
        ok = hit & (rel <= 1e-4)
        for lane in (0, 1, 2):
            np.testing.assert_allclose(got[..., lane][ok], want[..., lane][ok], rtol=1e-4,
                                       atol=1e-3)
        np.testing.assert_allclose(got[..., 4:7][ok], want[..., 4:7][ok], atol=1e-3)
        np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_frame_grabber_filter_matches_jax(grabbed):
    """``-f``: the port's filtered grab of pose B against JAX's guided
    filter of JAX's render of pose B on tests/test_torch_sensors.py's 96 x
    128 window, padded by twice the filter's radius 5 (the box means of the
    coefficients a and b widen the support to 2r) so that the window's
    pixels see the same neighbourhoods as in the full frame. Depth (the cloud's z)
    within the render bound plus the filter's 0.05 mm, colour within 1e-3
    plus 1e-4."""
    from icp_tpu.sensors import guided_filter as JGF

    root, printed = grabbed
    path = str(root / "torch" / "kg_pc8d_3.bin")
    got = _read_both(path).reshape(480, 640, 8)
    assert printed["torch"]["3"] == ("Applying guided filter (radius=5, eps=0.005)\n"
                                     f"Point cloud saved in {path} (307200 valid points)\n")
    pose = JY.CameraPose(jnp.asarray(Q_B, jnp.float32), jnp.asarray(T_B, jnp.float32))
    depth, rgb = JY.render(JY.default_scene(), pose)
    rows, cols, r = slice(190, 306), slice(250, 398), 10
    want_d = np.asarray(JGF.filter_depth(depth[rows, cols]))[r:-r, r:-r]
    want_c = np.asarray(JGF.filter_rgb(rgb[rows, cols]))[r:-r, r:-r]
    win = got[200:296, 260:388]
    np.testing.assert_allclose(win[..., 2], want_d, rtol=1e-4, atol=1e-3 + 0.05)
    np.testing.assert_allclose(win[..., 4:7], want_c, atol=1e-3 + 1e-4)
    # The filter leaves the other pixels' geometry on the same rays.
    np.testing.assert_allclose(win[..., 0], (np.arange(260, 388) - 319.5) * win[..., 2] / 595.0,
                               rtol=1e-5, atol=1e-3)


def _jax_registration():
    """The JAX example's registration app (its params and config)."""
    return JPIPE.ICPRegistration(icp_tpu.ICPParams(alpha=2e2, robust_delta=100.0),
                                 icp_tpu.ICPConfig(estimate_scale=False,
                                                   robust=icp_tpu.RobustKernel.NONE))


def _spy_jax_states(mp, cls, method):
    """Record what ``cls.method`` returns."""
    seen, real = [], getattr(cls, method)

    def spy(self, *a, **kw):
        seen.append(real(self, *a, **kw))
        return seen[-1]

    mp.setattr(cls, method, spy)
    return seen


def test_registration_on_grabbed_pair_matches_jax(grabbed, tmp_path, monkeypatch):
    """The grab-then-register workflow: both registration examples on the
    JAX-written pair (the port reads JAX's files; JAX reads the port's in
    :func:`test_frame_grabber_clouds_match_jax`)."""
    root, _ = grabbed
    jdir = str(root / "jax")
    states = _spy_jax_states(monkeypatch, JPIPE.ICPRegistration, "register_clouds")
    j_out = _jax_main(monkeypatch, JREG, ["kg_pc8d", "--data-dir", jdir, "--out-dir",
                                          str(tmp_path / "j")])
    ts, t_out = _port_main(TREG.main, ["kg_pc8d", "--data-dir", jdir, "--out-dir",
                                       str(tmp_path / "t")])
    js = states[0]
    assert _labels(t_out) == _labels(j_out)
    assert t_out.splitlines()[0] == j_out.splitlines()[0] == (
        f"Loading {jdir}/kg_pc8d_1.bin / {jdir}/kg_pc8d_2.bin")
    assert t_out.splitlines()[-1] == f"PLY written to {tmp_path / 't'}"
    assert sorted(os.listdir(tmp_path / "t")) == ["fixed.ply", "registered.ply"]
    # The fixed cloud passes through untouched: the same PLY, byte for byte.
    assert (tmp_path / "t" / "fixed.ply").read_bytes() == (tmp_path / "j" / "fixed.ply").read_bytes()
    assert os.path.getsize(tmp_path / "t" / "registered.ply") > 0
    assert abs(int(ts.k) - int(js.k)) <= 2 and max(int(ts.k), int(js.k)) < 40
    fixed, moving = (jnp.asarray(JNAT.read_cloud(f"{jdir}/kg_pc8d_{s}.bin")) for s in "12")
    app = _jax_registration()
    _assert_within_spread(ts, js, lambda mv: app.register_clouds(fixed, mv, verbose=False),
                          np.asarray(moving))
    for st in (ts, js):
        t_err, a_err = _gt_errors(st)
        assert t_err < 10.0 and a_err < 0.3, (t_err, a_err)


@pytest.fixture
def jax_renderer(monkeypatch):
    """The port's examples render through the JAX package's renderer (the
    same clouds as the JAX examples), on the CPU."""
    def render_cloud(scene, pose):
        jpose = JY.CameraPose(jnp.asarray(pose.q.numpy()), jnp.asarray(pose.t.numpy()))
        return torch.from_numpy(np.array(JY.render_cloud(JY.default_scene(), jpose)))

    monkeypatch.setattr(TY, "render_cloud", render_cloud)


def test_step_by_step_batch_matches_jax(tmp_path, monkeypatch, jax_renderer):
    """``step_by_step --synthetic --batch 3`` in both packages: the same
    report for every step, the same files, the states after 3 steps."""
    apps = []
    real_init = JPIPE.ICPStepByStep.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        apps.append(self)

    monkeypatch.setattr(JPIPE.ICPStepByStep, "__init__", init)
    j_out = _jax_main(monkeypatch, JSBS, ["--synthetic", "--batch", "3", "--out-dir",
                                          str(tmp_path / "j")])
    tapp, t_out = _port_main(TSBS.main, ["--synthetic", "--batch", "3", "--out-dir",
                                         str(tmp_path / "t")])
    js, ts = apps[0].state, tapp.state
    assert int(ts.k) == int(js.k) == 3
    assert _labels(t_out) == _labels(j_out)
    assert t_out.count("Iteration k = ") == 3
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "registered_k3.ply"]
    fixed, moving = (np.array(c) for c in JSBS.load_pair(
        type("Args", (), {"data_dir": "", "name": "", "synthetic": True})()))

    def run_jax(mv):
        app = JPIPE.ICPStepByStep(fixed, mv, icp_tpu.ICPParams(alpha=2e2),
                                  icp_tpu.ICPConfig(estimate_scale=False))
        app.build_rbc()
        for _ in range(3):
            app.step(verbose=False)
        return app.state

    _assert_within_spread(ts, js, run_jax, moving)


def test_step_by_step_live_streams_frames(tmp_path, jax_renderer):
    """``--live --batch 2`` headless: the port's LiveViewer writes one frame
    for the attach and one a step, beside the PLY."""
    pytest.importorskip("matplotlib")
    app, out = _port_main(TSBS.main, ["--synthetic", "--batch", "2", "--live", "--out-dir",
                                      str(tmp_path)])
    assert int(app.state.k) == 2
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.png", "frame_0001.png",
                                            "frame_0002.png", "registered_k2.ply"]
    assert out.splitlines()[-1] == f"PLY written to {tmp_path}; 3 live frames"


def test_examples_default_to_the_card(monkeypatch):
    """Without a device argument the examples put their tensors on the
    card: with none here, the renderer's constructors raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        TFG.main(["--out-dir", os.devnull])


# ---- the package exports ------------------------------------------------


def test_package_exports_are_their_modules_objects():
    from icp_tpu_torch import kernels, ops, rbc
    from icp_tpu_torch.ops import normals

    assert ops.grid_normals is normals.grid_normals
    assert ops.normals_for is normals.normals_for
    assert {"grid_normals", "normals_for"} <= set(ops.__all__)
    j_rbc = importlib.import_module("icp_tpu.rbc")
    names = sorted(n for n in vars(j_rbc) if not n.startswith("_")
                   and n not in ("construct", "grouping", "search"))
    assert len(names) == 12
    for name in names:
        obj = getattr(rbc, name)
        mod = importlib.import_module(f"icp_tpu_torch.rbc.{getattr(j_rbc, name).__module__.split('.')[-1]}")
        assert obj is getattr(mod, name), name
    for name, module in [("bin_search", "bin_search"), ("brute_nn", "brute_nn"),
                         ("bin_point_moments", "fused_step"), ("rep_assign", "fused_step"),
                         ("nearest_neighbor_brute", None)]:
        mod = importlib.import_module(f"icp_tpu_torch.kernels.{module}" if module
                                      else "icp_tpu_torch.ops.distance")
        assert getattr(kernels, name) is getattr(mod, name), name
        # A kernel's wrapper launches its entry point through native.launch.
        assert module is None or f'native.launch("icp_{name}"' in inspect.getsource(
            getattr(kernels, name)), name


@pytest.mark.parametrize("n_ry, n_rx", [(16, 16), (8, 32)])
def test_representative_landmark_indices_match_jax(rng, n_ry, n_rx):
    from icp_tpu.ops import sampling as JS
    from icp_tpu_torch.ops import sampling as TS
    from tests.utils import make_cloud8

    want = np.asarray(JS.representative_landmark_indices(n_ry, n_rx))
    got = TS.representative_landmark_indices(n_ry, n_rx, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    lms = make_cloud8(rng, 16384)
    reps = TS.get_representatives(torch.from_numpy(lms), n_ry, n_rx).numpy()
    np.testing.assert_array_equal(lms[got.numpy()], reps)
