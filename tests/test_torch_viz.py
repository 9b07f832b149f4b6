"""``icp_tpu_torch.viz`` against ``icp_tpu.viz``: the plots write PNGs
(matplotlib's Agg backend, as tests/test_viz.py), ``_subsample`` draws the
JAX package's rows bitwise from tensors, a plot without matplotlib raises
an ImportError that names it, and ``LiveViewer`` streams frames while
driving the port's ``ICPStepByStep`` (PLANE), whose state after two steps
is within the slice tolerances of tests/test_torch_slice.py (t within
0.01 mm, the angle within 2e-4 deg, the scale within 1e-5) of JAX's on the
JAX test's rendered pair, handed to both packages as numpy arrays."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp import pipeline as JPIPE
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.sensors import synthetic
from icp_tpu.viz import live as JLIVE
from icp_tpu_torch.icp import pipeline as TPIPE
from icp_tpu_torch.viz import live as TLIVE
from icp_tpu_torch.viz import plot as TPLOT
from tests.utils import make_cloud8


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def test_plots_write_pngs(tmp_path, rng):
    pytest.importorskip("matplotlib")
    cloud = make_cloud8(rng, 500)
    cloud[:50] = 0.0  # invalid points are dropped, not plotted
    p = str(tmp_path / "cloud.png")
    TPLOT.plot_cloud(torch.from_numpy(cloud), p, max_points=300, title="test")
    assert _is_png(p)
    f, m = make_cloud8(rng, 300), make_cloud8(rng, 300)
    t = m.copy()
    t[:, :3] += 5.0
    p = str(tmp_path / "reg.png")
    TPLOT.plot_registration(torch.from_numpy(f), m, torch.from_numpy(t), p, max_points=200)
    assert _is_png(p)
    est = [torch.from_numpy(rng.normal(size=3).astype(np.float32) * 10) for _ in range(8)]
    gt = [e.numpy() + rng.normal(size=3) for e in est]
    p = str(tmp_path / "traj.png")
    TPLOT.plot_trajectory(est, gt, p)
    assert _is_png(p)


@pytest.mark.parametrize("n, k, invalid", [(5000, 600, 700), (300, 600, 40), (2000, 1999, 0)])
def test_subsample_draws_jax_rows(rng, n, k, invalid):
    """The same rows as ``icp_tpu.viz.live._subsample`` for seeds 0 and 1,
    bitwise, with invalid (zero-geometry) rows spread through the cloud:
    fewer valid rows than ``k`` keep them all, in order."""
    cloud = make_cloud8(rng, n)
    cloud[rng.choice(n, invalid, replace=False)] = 0.0
    cloud[:3, 4:] = 0.0  # a zero colour keeps a row valid
    for seed in (0, 1):
        want = JLIVE._subsample(cloud, k, seed=seed)
        got = TLIVE._subsample(torch.from_numpy(cloud), k, seed=seed)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # A (h, w, 8) cloud takes the same rows as its (h * w, 8) view.
    np.testing.assert_array_equal(TLIVE._subsample(torch.from_numpy(cloud).reshape(n, 1, 8), k),
                                  JLIVE._subsample(cloud, k))


def test_plot_without_matplotlib_names_it(tmp_path, monkeypatch):
    """No fallback: with matplotlib missing, a plot raises ImportError that
    names it, and the viewer cannot start."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        TPLOT.plot_cloud(torch.zeros(4, 8), str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        TLIVE.LiveViewer(out_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "x.png")


def test_live_viewer_streams_and_matches_jax(tmp_path, one_thread):
    """tests/test_viz.py's headless stream on the port: attach() and two
    step() calls write frame_0000..0002.png and drive the port's
    ICPStepByStep, whose state then matches JAX's after two steps."""
    pytest.importorskip("matplotlib")
    scene = synthetic.default_scene()
    q = np.array([0, 0.004, 0, 1.0], np.float32)
    q /= np.linalg.norm(q)
    b_pose = synthetic.CameraPose(jnp.asarray(q),
                                  jnp.asarray(np.array([8.0, -4.0, 3.0], np.float32)))
    a, b = (np.array(synthetic.render_cloud(scene, p))
            for p in (synthetic.CameraPose.identity(), b_pose))

    # PLANE: POINT on a rendered pair parts from JAX at step 2 by up to
    # 3.4e-4 deg at the representative ties of tests/test_torch_pipeline.py.
    japp = JPIPE.ICPStepByStep(a, b, icp_tpu.ICPParams(alpha=2e2),
                               icp_tpu.ICPConfig(objective=icp_tpu.Objective.PLANE,
                                                 estimate_scale=False))
    app = TPIPE.ICPStepByStep(torch.from_numpy(a), torch.from_numpy(b),
                              icp_tpu_torch.ICPParams(alpha=2e2),
                              icp_tpu_torch.ICPConfig(objective=icp_tpu_torch.Objective.PLANE,
                                                      estimate_scale=False))
    out = str(tmp_path / "live")
    v = TLIVE.LiveViewer(out_dir=out, max_points=500)
    assert not v.interactive  # Agg in tests
    v.attach(app)
    v.step()
    v.step()
    v.close()
    frames = sorted(os.listdir(out))
    assert frames == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert all(_is_png(os.path.join(out, f)) for f in frames)

    for _ in range(2):
        js = japp.step(verbose=False)
    ts = app.state
    assert int(ts.k) == int(js.k) == 2
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.01
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 2e-4
    assert abs(float(ts.s) - float(js.s)) <= 1e-5
