"""icp_tpu_torch's grid normals (ops/normals.py) and its port of the sensor
layer that makes the rendered gate pair (sensors/pinhole.py,
sensors/synthetic.py) against icp_tpu on the same inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.ops import normals as JN
from icp_tpu.ops import sampling as JS
from icp_tpu.sensors import pinhole as JP
from icp_tpu.sensors import synthetic as JY
from icp_tpu_torch.ops import normals as TN
from icp_tpu_torch.ops import sampling as TS
from icp_tpu_torch.sensors import pinhole as TP
from icp_tpu_torch.sensors import synthetic as TY
from tests.test_icp_e2e import _structured_cloud
from tests.test_torch_knn import _jax_rbc_k9_branch

# bench.py's gate pose B: 0.008 rad about y, t = (10, -6, 8) mm.
Q_B = np.array([0.0, np.sin(0.004), 0.0, np.cos(0.004)], np.float32)
T_B = np.array([10.0, -6.0, 8.0], np.float32)
# Pixels whose nearest surface may differ between the two renderers: a ray
# grazing a silhouette, where float32 rounding decides between two hits.
MAX_SURFACE_FLIPS = 10


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _wavy_grid(rng, side):
    """An organized side x side grid on a wavy surface, with holes."""
    u, v = np.meshgrid(np.linspace(-400, 400, side), np.linspace(-300, 300, side))
    z = 1500 + 80 * np.sin(u / 90) + 60 * np.cos(v / 70)
    g = np.ones((side, side, 8), np.float32)
    g[..., 0], g[..., 1], g[..., 2] = u, v, z
    g[..., 4:7] = rng.uniform(0, 1, (side, side, 3))
    g[5, 7] = 0.0          # an isolated hole
    g[20:23, 30:34] = 0.0  # a hole patch
    g[0, 10] = 0.0         # a hole on the border
    g[:, -1] = 0.0         # a dead column on the edge
    return g.reshape(-1, 8)


@pytest.mark.parametrize("side", [16, 48])
def test_grid_normals_match_jax_with_holes(rng, side):
    pts = _wavy_grid(rng, side)
    want = np.asarray(JN.grid_normals(jnp.asarray(pts), side))
    got = TN.grid_normals(_t(pts), side).numpy()
    np.testing.assert_array_equal(np.all(got == 0, axis=1), np.all(want == 0, axis=1))
    np.testing.assert_allclose(got, want, atol=1e-5)
    nz = np.any(want != 0, axis=1)
    assert 0 < nz.sum() < len(nz)
    np.testing.assert_allclose(np.linalg.norm(got[nz], axis=1), 1.0, atol=1e-5)
    assert (got[:, 2] <= 0).all()  # camera-facing


def test_grid_normals_on_rendered_landmarks_match_jax(rendered):
    lms = rendered["b"]  # 128 x 128 organized landmarks, holes included
    want = np.asarray(JN.grid_normals(jnp.asarray(lms)))
    got = TN.grid_normals(_t(lms)).numpy()
    np.testing.assert_array_equal(np.all(got == 0, axis=1), np.all(want == 0, axis=1))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_normals_for_modes_match_jax(rng):
    square = _wavy_grid(rng, 16)
    np.testing.assert_allclose(TN.normals_for(_t(square), "auto").numpy(),
                               np.asarray(JN.normals_for(jnp.asarray(square), "auto")),
                               atol=1e-5)
    odd = square[:200]
    for mode in ("auto",):
        got = TN.normals_for(_t(odd), mode).numpy()
        np.testing.assert_array_equal(got, np.asarray(JN.normals_for(jnp.asarray(odd), mode)))
        assert not got.any()
    with pytest.raises(ValueError):
        JN.normals_for(jnp.asarray(odd), "grid")
    with pytest.raises(ValueError):
        TN.normals_for(_t(odd), "grid")
    # The unorganized-cloud estimators, on a random sample of the surface of
    # square size (a regular grid would tie kNN distances exactly). Off the
    # TPU, JAX's "knn_rbc" assigns bins with an XLA strip; the port's
    # dispatch is held to JAX's K9 branch, which the port runs everywhere.
    cloud = _structured_cloud(rng, 256)
    for mode, want in (("knn", np.asarray(JN.normals_for(jnp.asarray(cloud), "knn"))),
                       ("knn_rbc", _jax_rbc_k9_branch(cloud))):
        got = TN.normals_for(_t(cloud), mode).numpy()
        np.testing.assert_array_equal(np.all(got == 0, axis=1), np.all(want == 0, axis=1))
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_backproject_matches_jax(rng):
    depth = rng.uniform(800, 2500, (480, 640)).astype(np.float32)
    depth[::7, ::5] = 0.0
    rgb = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    want = np.asarray(JP.backproject(jnp.asarray(depth), jnp.asarray(rgb)))
    got = TP.backproject(_t(depth), _t(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert not got[::7, ::5, :3].any()


@pytest.fixture(scope="module")
def rendered():
    """Both renderers' clouds of the gate pair and the JAX landmarks."""
    out = {}
    poses = {"a": (JY.CameraPose.identity(), TY.CameraPose.identity(device="cpu")),
             "b": (JY.CameraPose(jnp.asarray(Q_B), jnp.asarray(T_B)),
                   TY.CameraPose(_t(Q_B), _t(T_B)))}
    for name, (jp, tp) in poses.items():
        out["j" + name] = np.asarray(JY.render_cloud(JY.default_scene(), jp))
        out["t" + name] = TY.render_cloud(TY.default_scene(device="cpu"), tp).numpy()
        out[name] = np.asarray(JS.get_landmarks(jnp.asarray(out["j" + name]).reshape(-1, 8)))
    return out


@pytest.mark.parametrize("pose", ["a", "b"])
def test_render_cloud_matches_jax(rendered, pose):
    """Identical hit masks; depth (and x, y) within 1e-4 relative and colour
    within 1e-3, except on the few silhouette pixels where the two
    renderers' float32 rounding picks a different surface: those are named
    and bounded."""
    want, got = rendered["j" + pose], rendered["t" + pose]
    assert got.shape == want.shape == (480, 640, 8)
    hit_w, hit_g = want[..., 2] > 0, got[..., 2] > 0
    np.testing.assert_array_equal(hit_g, hit_w)
    assert 0.5 < hit_w.mean() <= 1.0
    rel = np.abs(got[..., 2] - want[..., 2]) / np.maximum(want[..., 2], 1.0)
    flips = np.argwhere(rel > 1e-4)
    assert len(flips) <= MAX_SURFACE_FLIPS, f"surface flips at (v, u) {flips.tolist()}"
    ok = hit_w & (rel <= 1e-4)
    for lane in (0, 1, 2):
        np.testing.assert_allclose(got[..., lane][ok], want[..., lane][ok],
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[..., 4:7][ok], want[..., 4:7][ok], atol=1e-3)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_rendered_landmarks_match_jax(rendered):
    for pose in ("a", "b"):
        want = rendered[pose]
        got = TS.get_landmarks(_t(rendered["t" + pose]).reshape(-1, 8)).numpy()
        assert got.shape == (16384, 8)
        np.testing.assert_array_equal(got[:, 2] > 0, want[:, 2] > 0)
        both = want[:, 2] > 0
        rel = np.abs(got[both, 2] - want[both, 2]) / want[both, 2]
        assert (rel > 1e-4).sum() <= MAX_SURFACE_FLIPS


def test_scenes_match_jax():
    for jsc, tsc in ((JY.default_scene(), TY.default_scene(device="cpu")),
                     (JY.default_scene(3), TY.default_scene(3, device="cpu")),
                     (JY.wall_scene(), TY.wall_scene(device="cpu"))):
        np.testing.assert_array_equal(tsc.planes.numpy(), np.asarray(jsc.planes))
        np.testing.assert_array_equal(tsc.spheres.numpy(), np.asarray(jsc.spheres))


def test_texture_matches_jax(rng):
    p = rng.uniform(-1000, 2500, (4096, 3)).astype(np.float32)
    np.testing.assert_allclose(TY._texture(_t(p)).numpy(),
                               np.asarray(JY._texture(jnp.asarray(p))), atol=1e-5)
