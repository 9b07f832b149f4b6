"""icp_tpu_torch's RBC layer (grouping, construction, fused search) and its
ops (distances, samplers) against icp_tpu on the same numpy inputs."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.ops import distance as JD
from icp_tpu.ops import sampling as JS
from icp_tpu.rbc import construct as JC
from icp_tpu.rbc import grouping as JG
from icp_tpu.rbc import search as JR
from icp_tpu_torch.interop import index_from_numpy
from icp_tpu_torch.ops import distance as TD
from icp_tpu_torch.ops import sampling as TS
from icp_tpu_torch.rbc import construct as TC
from icp_tpu_torch.rbc import grouping as TG
from icp_tpu_torch.rbc import search as TR
from tests.utils import make_cloud8, random_quat

ALPHA = 150.0


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("n, n_bins, cap, given_counts", [
    (1000, 16, 64, False),     # typical occupancy
    (1000, 16, 40, True),      # capacity overflow, counts supplied
    (4096, 64, 96, False),
    (65536, 32768, 4, False),  # n_bins * n >= 2**31: the stable-sort path
])
def test_bin_sort_layout_matches_jax(rng, n, n_bins, cap, given_counts):
    ids = rng.integers(0, n_bins, n).astype(np.int32)
    counts = np.bincount(ids, minlength=n_bins).astype(np.int32)
    j = JG.bin_sort_layout(jnp.asarray(ids), n_bins, cap,
                           counts=jnp.asarray(counts) if given_counts else None)
    t = TG.bin_sort_layout(_t(ids), n_bins, cap,
                           counts=_t(counts) if given_counts else None)
    for name, a, b in zip(("sidx", "counts", "offsets", "valid"), j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert t[0].dtype == t[1].dtype == t[2].dtype == torch.int32


def test_group_rows_by_bin_matches_jax(rng):
    n, n_bins, cap = 2000, 32, 72
    ids = rng.integers(0, n_bins, n).astype(np.int32)
    a = rng.normal(size=(n, 8)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    empty = np.zeros((n, 0), np.float32)
    j = JG.group_rows_by_bin(jnp.asarray(ids), n_bins, cap,
                             (jnp.asarray(a), jnp.asarray(empty), jnp.asarray(b)))
    t = TG.group_rows_by_bin(_t(ids), n_bins, cap, (_t(a), _t(empty), _t(b)))
    for name in ("counts", "offsets", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    for x, y in zip(t.grouped, j.grouped):
        assert tuple(x.shape) == y.shape
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _db(rng, n):
    db = make_cloud8(rng, n)
    db[7:19] = 0.0  # zero-geometry (invalid sensor) points
    return db


@pytest.mark.parametrize("cap, with_ids", [(128, True), (48, False)])
def test_rbc_construct_matches_jax(rng, cap, with_ids):
    db = _db(rng, 1024)
    rep_ids = rng.choice(np.arange(20, 1024), 16, replace=False).astype(np.int32)
    reps = db[rep_ids]
    j = JC.rbc_construct(jnp.asarray(db), jnp.asarray(reps), jnp.float32(ALPHA),
                         cap, rep_db_ids=jnp.asarray(rep_ids) if with_ids else None)
    t = TC.rbc_construct(_t(db), _t(reps), ALPHA, cap,
                         rep_db_ids=_t(rep_ids) if with_ids else None)
    for f in dataclasses.fields(t):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if b is None:
            # Without normals the port leaves the normal fields out; JAX
            # fills normals/bin_normals with zeros and the GN fields with None.
            assert a is None or not np.asarray(a).any(), f.name
            continue
        if f.name == "layout":
            for x, y in zip(b[:3], a[:3]):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            continue
        a, b = np.asarray(a), b.numpy()
        assert b.shape == a.shape, f.name
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            continue
        fin = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=f.name)
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, err_msg=f.name)


def test_rbc_construct_with_normals_is_slice_2(rng):
    """Construction with fixed-surface normals (slice 2) against JAX: the
    grouped normals and K7's 12-wide payload bitwise, the GN translation
    tensor to rtol 1e-5; the POINT fields as without normals."""
    db = _db(rng, 1024)
    normals = rng.normal(size=(1024, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[7:19] = 0.0
    rep_ids = rng.choice(np.arange(20, 1024), 16, replace=False).astype(np.int32)
    j = JC.rbc_construct(jnp.asarray(db), jnp.asarray(db[rep_ids]),
                         jnp.float32(ALPHA), 128, rep_db_ids=jnp.asarray(rep_ids),
                         normals=jnp.asarray(normals))
    t = TC.rbc_construct(_t(db), _t(db[rep_ids]), ALPHA, 128,
                         rep_db_ids=_t(rep_ids), normals=_t(normals))
    for name in ("normals", "bin_normals", "bins_vals12", "bins_centered",
                 "bin_ids", "bin_mask"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert t.bins_vals12.is_contiguous()
    np.testing.assert_allclose(t.gn_w.numpy(), np.asarray(j.gn_w), rtol=1e-5,
                               atol=1e-6)
    # The payload's last lane is zero padding.
    assert not t.bins_vals12[..., 11].any()


@pytest.mark.parametrize("weighted", [True, False])
def test_rbc_point_moments_on_jax_index(rng, weighted):
    """The port's fused search on the JAX-built index (carried across with
    interop.index_from_numpy) gives the JAX package's Horn inputs."""
    db = _db(rng, 512)
    reps = db[rng.choice(np.arange(20, 512), 16, replace=False)]
    jidx = JC.rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                            jnp.float32(ALPHA), 64)
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu")
    moving = make_cloud8(rng, 512)
    moving[30:40] = 0.0
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    s = np.float32(1.002)
    want = JR.rbc_point_moments(jidx, jnp.asarray(moving), jnp.asarray(q),
                                jnp.asarray(t), jnp.float32(s),
                                jnp.float32(ALPHA), jnp.float32(1e-6), 64,
                                weighted=weighted, use_pallas=False)
    got = TR.rbc_point_moments(tidx, _t(moving), _t(q), _t(t), torch.tensor(s),
                               ALPHA, 1e-6, 64, weighted=weighted)
    for name, g, w in zip(("S11", "mean_f", "mean_m", "sum_w"), got, want):
        w = np.asarray(w)
        # Off-diagonal cross-covariance entries can cancel to ~1e-3 of the
        # largest: S11 is held to 1e-5 of its scale, as the Horn solve sees it.
        atol = 1e-5 * np.abs(w).max() if name == "S11" else 0.0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol,
                                   err_msg=name)


def test_pairwise_sq_dists_matches_jax(rng):
    a = make_cloud8(rng, 300)
    b = make_cloud8(rng, 40)
    want = np.asarray(JD.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b),
                                           jnp.float32(ALPHA)))
    got = TD.pairwise_sq_dists(_t(a), _t(b), ALPHA).numpy()
    # d2 reaches ~7e5: absolute tolerance at its float32 ulp.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-7 * want.max())
    np.testing.assert_array_equal(
        TD.metric_weights(ALPHA).numpy(),
        np.asarray(JD.metric_weights(jnp.float32(ALPHA))))


@pytest.mark.parametrize("n, n_r, grid", [(16384, 256, (16, 16)), (4096, 64, None),
                                          (1000, 16, None), (65536, 1024, None)])
def test_sample_representative_indices_matches_jax(n, n_r, grid):
    want = np.asarray(JS.sample_representative_indices(n, n_r, grid))
    got = TS.sample_representative_indices(n, n_r, grid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_get_landmarks_matches_jax(rng):
    cloud = rng.normal(size=(480, 640, 8)).astype(np.float32)
    want = np.asarray(JS.get_landmarks(jnp.asarray(cloud)))
    np.testing.assert_array_equal(TS.get_landmarks(_t(cloud)).numpy(), want)


@pytest.mark.parametrize("with_normals", [True, False])
def test_index_from_numpy_carries_normal_fields(rng, with_normals):
    """A JAX index crosses whole: with normals its grouped normals, K7's
    payload and the GN translation tensor arrive as they are; without, the
    JAX index's zero normals arrive as zeros and its None GN fields as None."""
    db = _db(rng, 256)
    normals = rng.normal(size=(256, 3)).astype(np.float32)
    jidx = JC.rbc_construct(jnp.asarray(db), jnp.asarray(db[40:56]), jnp.float32(ALPHA),
                            64, normals=jnp.asarray(normals) if with_normals else None)
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu")
    for name in ("normals", "bin_normals", "bins_vals12", "gn_w"):
        a, b = getattr(jidx, name), getattr(tidx, name)
        if a is None:
            assert b is None, name
        else:
            assert b.dtype == torch.float32, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (tidx.bins_vals12 is not None) == with_normals
