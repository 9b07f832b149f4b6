"""The fused Gauss-Newton path of icp_tpu_torch (K7's twin, the GN algebra,
the plane solve and rbc_gn_system) against icp_tpu on the same numpy inputs.

The JAX side runs as its own tests run it on the CPU: the XLA twins
(``bin_gn_moments_ref``, ``use_pallas=False``). On the CPU the port's K7
wrapper takes its twin, so these tests also hold the wrapper's dispatch;
the kernel itself is checked on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.icp import plane as JP
from icp_tpu.kernels import fused_gn as JG
from icp_tpu.kernels import fused_step as JF
from icp_tpu.rbc import construct as JC
from icp_tpu.rbc import search as JR
from icp_tpu_torch.icp import plane as TP
from icp_tpu_torch.interop import index_from_numpy
from icp_tpu_torch.kernels import fused_gn as TG
from icp_tpu_torch.kernels import fused_step as TF
from icp_tpu_torch.kernels import native
from icp_tpu_torch.rbc import search as TR
from tests.utils import make_cloud8, random_quat

ALPHA = 150.0
EPS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _unit(rng, shape):
    n = rng.normal(size=shape)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _gn_inputs(rng, n_r=8, cq=24, cb=32):
    """Grouped raw queries near their reps with moving normals, a 12-wide
    bin payload [centered points | fixed normals | 0] with masked slots, an
    empty bin (bin 2), zero-geometry rows and missing normals."""
    reps = make_cloud8(rng, n_r)
    mg = np.repeat(reps[:, None, :], cq, axis=1)
    mg[..., :3] += rng.normal(size=(n_r, cq, 3)) * 20
    mg[..., 4:7] = rng.uniform(0, 1, (n_r, cq, 3))
    mg[0, :5] = 0.0  # zero-geometry (invalid sensor) query rows
    nm = _unit(rng, (n_r, cq, 3))
    nm[1, :4] = 0.0  # moving points without a normal
    qvalid = (rng.uniform(size=(n_r, cq)) < 0.85).astype(np.float32)
    vals = np.zeros((n_r, cb, 12), np.float32)
    vals[..., :3] = rng.normal(size=(n_r, cb, 3)) * 20
    vals[..., 4:7] = rng.uniform(-0.5, 0.5, (n_r, cb, 3))
    vals[..., 8:11] = _unit(rng, (n_r, cb, 3))
    vals[:, :3, 8:11] = 0.0  # fixed points without a normal
    w8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)
    sq_b = np.sum(vals[..., :8] * w8 * vals[..., :8], axis=-1).astype(np.float32)
    sq_b[rng.uniform(size=sq_b.shape) < 0.3] = np.inf
    sq_b[2] = np.inf
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    G, b_row = JF.prep_similarity(jnp.asarray(q), jnp.asarray(t), jnp.float32(1.0))
    return (mg.astype(np.float32), nm, qvalid, reps, vals, sq_b, np.asarray(G),
            np.asarray(b_row))


def _median_delta(args):
    """A robust scale at the median NN distance of these inputs, so the
    robust factor acts on about half of the pairs."""
    mg, _, qvalid, reps, vals, sq_b, G, b_row = args
    d2 = TF.bin_min_dists_ref(_t(mg), _t(qvalid), _t(reps), _t(vals[..., :8]),
                              _t(sq_b), _t(G), _t(b_row), ALPHA).numpy()
    return float(np.sqrt(np.median(d2[np.isfinite(d2)])))


@pytest.mark.parametrize("robust", ["none", "huber", "trimmed"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
def test_bin_gn_moments_twin_matches_jax(rng, mode, weighted, robust):
    args = _gn_inputs(rng)
    mg, nm, qvalid, reps, vals, sq_b, G, b_row = args
    nm = None if mode == "plane" else nm
    kw = dict(mode=mode, weighted=weighted, robust=robust,
              robust_delta=_median_delta(args), gicp_eps=EPS)
    want = JG.bin_gn_moments_ref(
        *(None if a is None else jnp.asarray(a)
          for a in (mg, nm, qvalid, reps, vals, sq_b, G, b_row)),
        jnp.float32(ALPHA), **kw)
    got = TG.bin_gn_moments(*(None if a is None else _t(a)
                              for a in (mg, nm, qvalid, reps, vals, sq_b, G, b_row)),
                            ALPHA, **kw)
    if mode != "gicp":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
        # The empty bin contributes nothing.
        np.testing.assert_array_equal(g.numpy()[2], 0.0)
    assert native.launches()["bin_gn_moments"] == 0


def test_bin_gn_moments_scalars_as_tensors_equal_floats(rng):
    a = tuple(map(_t, _gn_inputs(rng)))
    kw = dict(mode="gicp", weighted=True, robust="huber")
    x = TG.bin_gn_moments(*a, ALPHA, robust_delta=12.0, gicp_eps=EPS, **kw)
    y = TG.bin_gn_moments(*a, torch.tensor(ALPHA), robust_delta=torch.tensor(12.0),
                          gicp_eps=torch.tensor(EPS), **kw)
    for u, v in zip(x, y):
        assert torch.equal(u, v)


def test_bin_gn_moments_rejects_bad_arguments(rng):
    a = list(map(_t, _gn_inputs(rng)))
    with pytest.raises(ValueError):
        TG.bin_gn_moments(*a, ALPHA, mode="lane", weighted=True)
    a[1] = None
    with pytest.raises(ValueError):
        TG.bin_gn_moments(*a, ALPHA, mode="gicp", weighted=True)


def test_gicp_const_moment_matches_jax(rng):
    P_z = (rng.normal(size=(16, 8, 8)) * 30.0).astype(np.float32)
    P_z = P_z + P_z.transpose(0, 2, 1)
    want = np.asarray(JG.gicp_const_moment(jnp.asarray(P_z)))
    got = TG.gicp_const_moment(_t(P_z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gn_translation_tensor_matches_jax(rng):
    reps = make_cloud8(rng, 32)
    want = np.asarray(JG.gn_translation_tensor(jnp.asarray(reps)))
    got = TG.gn_translation_tensor(_t(reps)).numpy()
    assert got.shape == (32, 8, 8, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gn_v_total_hoisted_and_direct_match_jax(rng):
    """V via the hoisted W_t product equals the direct per-bin congruence,
    and both equal the JAX package's (coefficients reach ~4e6)."""
    reps = make_cloud8(rng, 16)
    P = (rng.normal(size=(16, 8, 8)) * 20.0).astype(np.float32)
    want = np.asarray(JG.gn_v_total(jnp.asarray(P), jnp.asarray(reps)))
    scale = np.abs(want).max()
    direct = TG.gn_v_total(_t(P), _t(reps)).numpy()
    fast = TG.gn_v_total(_t(P), _t(reps), TG.gn_translation_tensor(_t(reps))).numpy()
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(fast, want, rtol=1e-5, atol=1e-6 * scale)


def test_gn_system_from_V_matches_jax(rng):
    V = (rng.normal(size=(8, 8)) * 1e4).astype(np.float32)
    jH, jb = JG.gn_system_from_V(jnp.asarray(V), JP.CHARACTERISTIC_LENGTH_MM)
    H, b = TG.gn_system_from_V(_t(V), TP.CHARACTERISTIC_LENGTH_MM)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5)


def _plane_pairs(rng, n=400):
    mv = make_cloud8(rng, n)[:, :3]
    normals = _unit(rng, (n, 3))
    f = mv - normals * rng.normal(size=(n, 1)).astype(np.float32) * 3.0
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return mv, f.astype(np.float32), normals, w, mask


def test_plane_system_partials_match_jax(rng):
    mv, f, n, w, mask = _plane_pairs(rng)
    jH, jb = JP.plane_system_partials(*map(jnp.asarray, (mv, f, n, w, mask)))
    H, b = TP.plane_system_partials(*map(_t, (mv, f, n, w, mask)))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jH)).max())
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jb)).max())


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_solve_plane_system_matches_jax(rng, scale):
    """A system with a real increment, and the all-zero system (damping
    only: the identity step)."""
    mv, f, n, w, mask = _plane_pairs(rng)
    H, b = JP.plane_system_partials(*map(jnp.asarray, (mv, f, n, w, mask)))
    H, b = np.asarray(H) * scale, np.asarray(b) * scale
    jq, jt = JP.solve_plane_system(jnp.asarray(H), jnp.asarray(b))
    q, t = TP.solve_plane_system(_t(H), _t(b))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    jq2, jt2 = JP.solve_point_to_plane(*map(jnp.asarray, (mv, f, n, w, mask)))
    q2, t2 = TP.solve_point_to_plane(*map(_t, (mv, f, n, w, mask)))
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode, robust, adaptive", [
    ("plane", "none", False),
    ("plane_sym", "huber", False),
    ("gicp", "none", False),
    ("plane", "trimmed", True),
])
def test_rbc_gn_system_on_jax_index(rng, mode, robust, adaptive):
    """The port's fused GN search on the JAX-built index (normals included,
    carried across whole by interop.index_from_numpy) gives the JAX
    package's global GN moment matrix V."""
    n = 512
    db = make_cloud8(rng, n)
    db[7:19] = 0.0
    normals = _unit(rng, (n, 3))
    reps = db[rng.choice(np.arange(20, n), 16, replace=False)]
    jidx = JC.rbc_construct(jnp.asarray(db), jnp.asarray(reps), jnp.float32(ALPHA),
                            64, normals=jnp.asarray(normals))
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu")
    assert tidx.bins_vals12 is not None and tidx.gn_w is not None
    moving = make_cloud8(rng, n)
    moving[30:40] = 0.0
    mn = _unit(rng, (n, 3))
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    kw = dict(mode=mode, weighted=True, robust=robust, robust_delta=40.0,
              robust_adaptive=adaptive, gicp_eps=EPS)
    want = np.asarray(JR.rbc_gn_system(
        jidx, jnp.asarray(moving), jnp.asarray(q), jnp.asarray(t), jnp.float32(1.0),
        jnp.float32(ALPHA), 64, use_pallas=False,
        mnormals_rot=None if mode == "plane" else jnp.asarray(mn), **kw))
    got = TR.rbc_gn_system(tidx, _t(moving), _t(q), _t(t), torch.tensor(1.0),
                           ALPHA, 64, mnormals_rot=None if mode == "plane" else _t(mn),
                           **kw).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_rbc_gn_system_needs_normals(rng):
    from icp_tpu_torch.rbc.construct import rbc_construct

    db = make_cloud8(rng, 256)
    idx = rbc_construct(_t(db), _t(db[:16]), ALPHA, 64)
    with pytest.raises(ValueError, match="normals"):
        TR.rbc_gn_system(idx, _t(db), _t(np.array([0, 0, 0, 1], np.float32)),
                         torch.zeros(3), torch.tensor(1.0), ALPHA, 64,
                         mode="plane", weighted=True)
