"""icp_tpu_torch's kNN normals for unorganized clouds against icp_tpu on the
same inputs: K9 (rep_top2_counts) and K8 (bin_knn_moments) twins against the
interpret-mode Pallas kernels, the Morton order, the closed-form 3x3
eigenvector, the brute and RBC estimators, ``wavy_surface_pair`` and the
PLANE / GICP registrations of an unorganized pair."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.kernels import knn_moments as JK
from icp_tpu.ops import normals as JN
from icp_tpu.sensors import synthetic as JY
from icp_tpu_torch.interop import config_from_dict
from icp_tpu_torch.kernels import knn_moments as TK
from icp_tpu_torch.ops import normals as TN
from icp_tpu_torch.sensors import synthetic as TY
from tests.test_icp_e2e import _make_pair, _structured_cloud
from tests.test_knn_normals import _analytic_normals


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_top2(p, reps):
    i1, i2, counts = JK.rep_top2_counts_pallas(jnp.asarray(p), jnp.asarray(reps),
                                               block_m=512, interpret=True)
    return np.asarray(i1), np.asarray(i2), np.asarray(counts)


def _morton_reps(p, n_r):
    stride = p.shape[0] // n_r
    return p[np.asarray(JN._morton_order(jnp.asarray(p)))[stride // 2::stride][:n_r]]


# ---- K9: rep_top2_counts ----------------------------------------------------


def test_rep_top2_twin_matches_interpret_on_reference_data(rng):
    """The reference test's data (tests/test_knn_normals.py): ids and counts
    exactly equal to the interpret-mode kernel."""
    m, n_r = 2048, 64
    p = rng.normal(size=(m, 3)).astype(np.float32) * 100
    reps = p[rng.choice(m, n_r, replace=False)]
    want = _jax_top2(p, reps)
    got = [x.numpy() for x in TK.rep_top2_counts(_t(p), _t(reps))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rep_top2_twin_on_raw_wavy_surface():
    """A raw wavy-surface cloud at z ~ 1500 mm with Morton reps: the score's
    cancellation of raw coordinates is the reference's. Every id equal, or
    the two picks a float64 near-tie of the score |r|^2 - 2 p.r (K1's rule:
    within 1e-5 of its magnitude, ~2.3e6 here, where bf16x3 rounds at ~30;
    inside its jitted kernel JAX splits one exact float32 tie of the twin's
    scores the other way); counts equal the bincounts."""
    p = TY.wavy_surface_pair(4096)[0][:, :3].copy()
    reps = _morton_reps(p, 64)
    want = _jax_top2(p, reps)
    i1, i2, counts = (x.numpy() for x in TK.rep_top2_counts(_t(p), _t(reps)))
    r64 = reps.astype(np.float64)
    s64 = (r64 ** 2).sum(-1)[None, :] - 2.0 * p.astype(np.float64) @ r64.T
    n_diff = 0
    for got, ref in ((i1, want[0]), (i2, want[1])):
        diff = got != ref
        n_diff += int(diff.sum())
        rows = np.nonzero(diff)[0]
        gap = np.abs(s64[rows, got[rows]] - s64[rows, ref[rows]])
        assert np.all(gap <= 1e-5 * np.maximum(np.abs(s64[rows, ref[rows]]), 1.0))
    print(f"K9 twin vs interpret on the raw wavy surface: {n_diff} ids differ")
    assert n_diff <= 0.001 * 2 * p.shape[0]
    np.testing.assert_array_equal(counts[0], np.bincount(i1, minlength=64))
    np.testing.assert_array_equal(counts[1], np.bincount(i2, minlength=64))


def test_rep_top2_twin_planted_ties():
    """Integer coordinates make every score exact: duplicated reps, points
    equidistant to three reps (the origin against three reps of equal norm)
    and exact ties everywhere. The tie rule (first minimum, then the first
    minimum with only the winner's column masked) matches the kernel's."""
    g = np.random.default_rng(3)
    p = g.integers(-4, 5, size=(1024, 3)).astype(np.float32)
    reps = g.integers(-3, 4, size=(16, 3)).astype(np.float32)
    reps[5] = reps[2]
    reps[11] = reps[2]
    reps[[0, 7, 13]] = [[10, 0, 0], [0, 10, 0], [0, 0, 10]]
    p[:4] = 0.0
    p[4:8] = reps[2]
    want = _jax_top2(p, reps)
    got = [x.numpy() for x in TK.rep_top2_counts(_t(p), _t(reps))]
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt, w)
    assert np.all(got[0][4:8] == 2) and np.all(got[1][4:8] == 5)


@pytest.mark.parametrize("multi_assign", [1, 3])
def test_strip_path_matches_jax(rng, multi_assign):
    """The fp32 masked-argmin front half (multi_assign other than 2): the
    same zero set as JAX's estimator and normals within 1e-5 elsewhere."""
    cloud = _structured_cloud(rng, 4096)
    want = np.asarray(JN.knn_normals_rbc(jnp.asarray(cloud), multi_assign=multi_assign))
    got = TN.knn_normals_rbc(_t(cloud), multi_assign=multi_assign).numpy()
    zw, zg = (want == 0).all(1), (got == 0).all(1)
    np.testing.assert_array_equal(zg, zw)
    np.testing.assert_allclose(got[~zw], want[~zw], atol=1e-5)


# ---- K8: bin_knn_moments ----------------------------------------------------


def _knn_moment_inputs(rng):
    """The reference test's inputs: underfull bins and a NaN entry."""
    n_r, cq, cb = 8, 16, 128
    reps = rng.normal(size=(n_r, 3)).astype(np.float32) * 100
    qp = reps[:, None, :] + rng.normal(size=(n_r, cq, 3)).astype(np.float32) * 40
    bins = reps[:, None, :] + rng.normal(size=(n_r, cb, 3)).astype(np.float32) * 40
    bvalid = np.ones((n_r, cb), bool)
    for r in range(n_r):
        bvalid[r, int(rng.integers(4, cb)):] = False
    bins[2, 1] = np.nan
    return qp, bins, reps, bvalid


def _check_moments(args, k):
    """cnt exactly and the components within the reference test's bounds,
    against the interpret-mode kernel and the XLA twin."""
    jargs = tuple(map(jnp.asarray, args))
    got_c, got_n = TK.bin_knn_moments(*map(_t, args), k=k)
    for want_c, want_n in (JK.bin_knn_moments_pallas(*jargs, k=k, interpret=True),
                           JK.bin_knn_moments_ref(*jargs, k=k)):
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        for g, w in zip(got_c, want_c):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-2)
            assert np.all(np.isfinite(g.numpy()))
    return got_c, got_n


def test_bin_knn_moments_twin_matches_jax(rng):
    args = _knn_moment_inputs(rng)
    bins, bvalid = args[1], args[3]
    k = 12
    _, cnt = _check_moments(args, k)
    nv = (bvalid & np.isfinite(bins).all(-1)).sum(-1)
    full = nv >= k
    assert np.all(cnt.numpy()[full] >= k) and np.all(cnt.numpy()[full] <= k + 2)
    for r in np.nonzero(~full)[0]:
        assert np.all(cnt.numpy()[r] == max(nv[r], 1))


def test_bin_knn_moments_twin_at_the_lidar_bin_shape(monkeypatch):
    """The tables the port's own estimator builds at the LiDAR bin shape
    (cq 192, cb 384, k 16): 512 wavy-surface points over 4 bins, a few
    dropouts; the arguments are taken from the estimator's call."""
    cloud = TY.wavy_surface_pair(512)[0]
    cloud[[3, 77, 300]] = 0.0
    seen = []
    real = TN.bin_knn_moments

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(TN, "bin_knn_moments", spy)
    TN.knn_normals_rbc(_t(cloud), n_r=4)
    (qp, bins, reps, bvalid), kw = seen[0]
    assert qp.shape == (4, 192, 3) and bins.shape == (4, 384, 3) and kw["k"] == 16
    args = tuple(x.contiguous().numpy() for x in (qp, bins, reps, bvalid))
    _check_moments(args, 16)


# ---- Morton order and the 3x3 eigenvector -----------------------------------


def test_morton_order_matches_jax(rng):
    for p in (_structured_cloud(rng, 4096)[:, :3],
              TY.wavy_surface_pair(3000)[0][:, :3].copy(),
              rng.integers(0, 4, size=(777, 3)).astype(np.float32)):  # many equal keys
        want = np.asarray(JN._morton_order(jnp.asarray(p)))
        got = TN._morton_order(_t(p))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_smallest_eigvec3_matches_jax_and_eigh(rng):
    """Near-planar PSD batches (the reference test's) and degenerate ones:
    within 1e-5 of JAX's closed form, and along numpy's eigh vector."""
    A = rng.normal(size=(512, 16, 3)).astype(np.float32)
    A[:, :, 2] *= 0.05
    C = np.einsum("bki,bkj->bij", A, A)
    C[:4] = 0.0  # no scatter: the +z fallback
    C[4:8] = np.eye(3, dtype=np.float32) * 5.0  # isotropic
    want = np.asarray(JN._smallest_eigvec3(jnp.asarray(C)))
    got = TN._smallest_eigvec3(_t(C)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[:4], [[0.0, 0.0, 1.0]] * 4)
    _, vecs = np.linalg.eigh(C[8:])
    assert np.min(np.abs(np.sum(got[8:] * vecs[..., 0], axis=-1))) > 0.999


# ---- the estimators ---------------------------------------------------------


@pytest.mark.parametrize("m, k, block, dropouts", [(4096, 16, 2048, False),
                                                   (512, 8, 256, True)])
def test_knn_normals_brute_matches_jax(rng, m, k, block, dropouts):
    cloud = _structured_cloud(rng, m)
    if dropouts:
        cloud[100:120] = 0.0
    want = np.asarray(JN.knn_normals(jnp.asarray(cloud), k=k, block=block))
    got = TN.knn_normals(_t(cloud), k=k, block=block).numpy()
    np.testing.assert_array_equal((got == 0).all(1), (want == 0).all(1))
    close = np.abs(got - want).max(1) <= 1e-4
    assert close.mean() >= 0.999, close.mean()


def _jax_rbc_k9_branch(cloud, k=16):
    """JAX's knn_normals_rbc with its K9 branch, built by hand from the
    package's own functions (icp_tpu/ops/normals.py:257-291): off the TPU
    the package takes the XLA strip instead."""
    points8 = jnp.asarray(cloud)
    p = points8[:, :3]
    m = p.shape[0]
    n_r = max(64, 1 << max(0, (m // 128 - 1).bit_length()))
    valid = jnp.sum(jnp.abs(p), axis=-1) > 0
    stride = m // n_r
    reps = p[JN._morton_order(p)[stride // 2::stride][:n_r]]
    i1, i2, counts = JK.rep_top2_counts_pallas(p, reps, block_m=512, interpret=True)
    return np.asarray(JN._knn_rbc_tail(points8, p, valid, jnp.stack([i1, i2], -1),
                                       counts, reps, n_r, m, k, 2, 128))


def test_knn_normals_rbc_matches_jax_k9_branch(rng):
    cloud = _structured_cloud(rng, 4096)
    cloud[200:230] = 0.0
    want = _jax_rbc_k9_branch(cloud)
    got = TN.knn_normals_rbc(_t(cloud)).numpy()
    zw = (want == 0).all(1)
    np.testing.assert_array_equal((got == 0).all(1), zw)
    assert zw[200:230].all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_knn_normals_rbc_analytic_bounds(rng):
    """The reference test's analytic-surface bounds (tests/test_knn_normals.py)."""
    cloud = _structured_cloud(rng, 4096)
    n_est = TN.knn_normals_rbc(_t(cloud)).numpy()
    cos = np.abs(np.sum(n_est * _analytic_normals(cloud), axis=-1))
    assert np.median(cos) > 0.999
    assert np.mean(cos > 0.99) > 0.95
    assert np.all(np.sum(n_est * cloud[:, :3], axis=-1) <= 1e-3)
    assert np.mean((n_est == 0).all(1)) < 0.02


def test_normals_for_knn_dispatch(rng, monkeypatch):
    """"knn" is the brute estimator up to 16384 points and the RBC one
    above; "knn_rbc" is the RBC one at any size; both match JAX's dispatch."""
    cloud = _structured_cloud(rng, 1000)
    got = TN.normals_for(_t(cloud), "knn").numpy()
    np.testing.assert_array_equal(got, TN.knn_normals(_t(cloud)).numpy())
    want = np.asarray(JN.normals_for(jnp.asarray(cloud), "knn"))
    assert (np.abs(got - want).max(1) <= 1e-4).mean() >= 0.999
    np.testing.assert_array_equal(TN.normals_for(_t(cloud), "knn_rbc").numpy(),
                                  TN.knn_normals_rbc(_t(cloud)).numpy())
    calls = []
    monkeypatch.setattr(TN, "knn_normals_rbc", lambda p: calls.append(p.shape[0]))
    TN.normals_for(torch.zeros((16385, 8)), "knn")
    TN.normals_for(torch.zeros((16384, 8)), "knn_rbc")
    assert calls == [16385, 16384]


def test_wavy_surface_pair_matches_jax():
    for got, want in zip(TY.wavy_surface_pair(4096), JY.wavy_surface_pair(4096)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---- the slice: PLANE and GICP on an unorganized pair -----------------------


@pytest.mark.parametrize("objective, normal_mode", [("plane", "knn_rbc"),
                                                   ("plane", "knn"),
                                                   ("gicp", "knn_rbc")])
def test_register_knn_matches_jax(rng, objective, normal_mode):
    """``icp_tpu_torch.register`` against ``icp_tpu.register`` on the
    reference test's unorganized pair (m 4096, n_r 64): both within the
    reference test's truth bounds (0.5 mm, 0.05 deg), the port within
    0.05 mm and 0.005 deg of JAX (the PLANE agreement bound of PERF.md)."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    d = dict(m=4096, n_r=64, objective=objective, normal_mode=normal_mode,
             estimate_scale=False)
    jcfg = icp_tpu.ICPConfig(**dict(d, objective=icp_tpu.Objective(objective)))
    js = icp_tpu.register(jnp.asarray(fixed), jnp.asarray(moving),
                          icp_tpu.ICPParams(alpha=2e2).as_f32(), jcfg)
    ts = icp_tpu_torch.register(_t(fixed), _t(moving), icp_tpu_torch.ICPParams(alpha=2e2),
                                config_from_dict(d))
    for t, q in ((np.asarray(js.t), js.q), (ts.t.numpy(), jnp.asarray(ts.q.numpy()))):
        assert np.linalg.norm(t - t_true) < 0.5
        assert float(qangle_deg(qmul(q, qconj(jnp.asarray(q_true))))) < 0.05
    assert np.linalg.norm(ts.t.numpy() - np.asarray(js.t)) <= 0.05
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 0.005
    assert float(ts.s) == 1.0


def test_register_knn_estimates_normals_once_per_cloud(monkeypatch):
    """A GICP registration with kNN normals estimates them once for the
    fixed cloud (the index build) and once for the moving cloud (the loop),
    on the input's device, never per step."""
    from icp_tpu_torch.icp import run as TRUN
    from icp_tpu_torch.icp import step as TSTEP

    calls = []
    real = TN.normals_for

    def counting(where):
        def f(points8, mode="auto"):
            calls.append((where, mode, points8.device.type))
            return real(points8, mode)
        return f

    monkeypatch.setattr(TRUN, "normals_for", counting("run"))
    monkeypatch.setattr(TSTEP, "normals_for", counting("step"))
    fixed, moving = (_t(a) for a in TY.wavy_surface_pair(2048)[:2])
    cfg = config_from_dict(dict(m=2048, n_r=32, objective="gicp", normal_mode="knn_rbc",
                                estimate_scale=False, max_iterations=3))
    st = icp_tpu_torch.register(fixed, moving, icp_tpu_torch.ICPParams(alpha=2e2), cfg)
    assert int(st.k) == 3
    assert calls == [("run", "knn_rbc", "cpu")] * 2
