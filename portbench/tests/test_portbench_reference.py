"""The plain reference against a brute-force NumPy ICP at tiny sizes: with
one representative whose bin holds every point, its search is the exact
nearest neighbour, so both follow the same iterates."""

import numpy as np
import pytest
import torch

from portbench import scene
from portbench.reference import icp as ref
from portbench.reference import normals as ref_normals

W8 = np.array([1, 1, 1, 0, 200, 200, 200, 0], dtype=np.float64)


def _rot(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def numpy_icp(fixed, moving, iters, normals=None, estimate_scale=True):
    """Exact-NN ICP in float64: Horn with scale (POINT) or one damped
    point-to-plane step (normals given); poses after each iteration."""
    q, t, s, out = np.array([0, 0, 0, 1.0]), np.zeros(3), 1.0, []
    for _ in range(iters):
        tm = moving.copy()
        tm[:, :3] = s * moving[:, :3] @ _rot(q).T + t
        d2 = (((tm[:, None, :] - fixed[None]) ** 2) * W8).sum(-1)
        j = d2.argmin(1)
        w = 100.0 / (100.0 + d2[np.arange(len(j)), j])
        m, f = tm[:, :3], fixed[j, :3]
        if normals is None:
            mm_, mf = (w[:, None] * m).sum(0) / w.sum(), (w[:, None] * f).sum(0) / w.sum()
            dm, df = m - mm_, f - mf
            S = (w[:, None] * dm).T @ df
            (a, b, c), (d, e, g), (h, i, k) = S
            N = np.array([[a - e - k, b + d, h + c, g - i], [b + d, -a + e - k, g + i, h - c],
                          [h + c, g + i, -a - e + k, b - d], [g - i, h - c, b - d, a + e + k]])
            qk = np.linalg.eigh(N)[1][:, -1]
            qk = -qk if qk[3] < 0 else qk
            sk = np.sqrt((w * (df ** 2).sum(1)).sum() / (w * (dm ** 2).sum(1)).sum()) \
                if estimate_scale else 1.0
            tk = mf - sk * _rot(qk) @ mm_
        else:
            n = normals[j]
            J = np.concatenate([n, np.cross(m, n) / 1e3], 1)
            r = ((m - f) * n).sum(1)
            delta = -np.linalg.solve((J * w[:, None]).T @ J + 1e-6 * np.eye(6),
                                     (J * w[:, None]).T @ r)
            om = delta[3:] / 1e3
            a = np.linalg.norm(om)
            qk = np.concatenate([np.sin(a / 2) * om / a, [np.cos(a / 2)]])
            tk, sk = delta[:3], 1.0
        q = _qmul(qk, q)
        q /= np.linalg.norm(q)
        t = sk * _rot(qk) @ t + tk
        s *= sk
        out.append((q, t, s))
    return out


CFG = {"n_r": 1, "alpha": 200.0, "c": 1e-6, "weighted": True, "max_iterations": 6,
       "angle_threshold_deg": 0.0, "translation_threshold_mm": 0.0}


@pytest.mark.parametrize("objective", ["point", "plane"])
def test_reference_follows_brute_force_numpy_icp(objective):
    pool = scene.make_pool(11, {"points": 256, "sampling": "grid",
                                "motion": {"rot_max_rad": 0.02, "trans_max_mm": 14.0}},
                           2, "cpu")
    fixed, moving = pool["frames"][0], pool["frames"][1]
    cfg = dict(CFG, objective=objective, estimate_scale=objective == "point")
    normals = ref_normals.knn_normals(fixed) if objective == "plane" else None
    got = ref.register(fixed, moving, cfg, normals)
    want = numpy_icp(fixed.double().numpy(), moving.double().numpy(), 6,
                     None if normals is None else normals.double().numpy(),
                     estimate_scale=objective == "point")
    assert got["k"] == 6
    for (q, t, s), (qw, tw, sw) in zip(got["poses"], want):
        np.testing.assert_allclose(t.numpy(), tw, atol=2e-3)
        np.testing.assert_allclose(q.numpy(), qw, atol=1e-6)
        assert abs(s - sw) < 1e-6


def test_exact_normals_are_the_surface_normals():
    u, v = torch.meshgrid(torch.linspace(-200, 200, 48), torch.linspace(-150, 150, 48),
                          indexing="ij")
    pts = scene.surface_points(u.reshape(-1), v.reshape(-1))
    n = ref_normals.knn_normals(pts).double()
    x, y = pts[:, 0].double(), pts[:, 1].double()
    dzdu, dzdv = 80 / 90 * torch.cos(x / 90), -60 / 70 * torch.sin(y / 70)
    true = torch.stack([dzdu, dzdv, -torch.ones_like(x)], 1)
    true = true / true.norm(dim=1, keepdim=True)
    assert float((n * true).sum(1).abs().median()) > 0.999
    assert bool(((n * pts[:, :3].double()).sum(1) <= 0).all())  # facing the origin


def test_ball_normals_match_exact_normals_inside_the_balls(monkeypatch):
    pts = scene.make_pool(3, {"points": 8192, "sampling": "uniform",
                              "motion": {"rot_max_rad": 0.0, "trans_max_mm": 0.0}},
                          2, "cpu")["frames"][0]
    exact = ref_normals.knn_normals(pts)
    monkeypatch.setattr(ref_normals, "EXACT_MAX", 1024)
    balls = ref_normals.knn_normals(pts)
    have = balls.abs().sum(1) > 0
    assert float(have.double().mean()) > 0.9
    assert float((balls[have] * exact[have]).sum(1).abs().median()) > 0.9999
