"""BRUTE correspondence of the port against icp_tpu on the same numpy inputs:
the K6 twin (``brute_nn_ref``) against the Pallas kernel in interpret mode,
and ``nearest_neighbor_brute`` against the XLA exact-NN baseline.

On the CPU the wrapper takes its twin; the kernel is checked on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels.brute_nn import brute_nn_pallas, nearest_neighbor_brute_pallas
from icp_tpu.ops import distance as JD
from icp_tpu_torch.ops import distance as TD
from tests.utils import make_cloud8

# The module, not the wrapper the package exports under its name.
TB = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

ALPHA = 180.0
W8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _weighted(q, db):
    qw = (q * W8).astype(np.float32)
    sq_db = (db * W8 * db).sum(-1).astype(np.float32)
    return qw, db, sq_db


def _lane_order_scores(qw, db, sq_db):
    """sq_db - 2 qw . db in numpy float32, lane by lane: the rounding the
    kernel and the twin share."""
    cross = qw[:, None, 0] * db[None, :, 0]
    for k in range(1, 8):
        cross = cross + qw[:, None, k] * db[None, :, k]
    return sq_db[None, :] - np.float32(2.0) * cross


@pytest.mark.parametrize("m, n, tiles", [(256, 512, {}),
                                         (128, 256, {"tq": 32, "td": 64})])
def test_brute_nn_twin_matches_pallas(rng, m, n, tiles):
    """Indices equal the interpret-mode kernel's (one tile, and tiles on
    both grid axes with the running-best carry); scores at
    test_brute_pallas.py's bound (the MXU sums in another order)."""
    args = _weighted(make_cloud8(rng, m), make_cloud8(rng, n))
    i_p, s_p = brute_nn_pallas(*map(jnp.asarray, args), interpret=True, **tiles)
    idx, score = TB.brute_nn(*map(_t, args))
    assert idx.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(score.numpy(), np.asarray(s_p), rtol=1e-4, atol=1.0)
    assert TB.brute_nn.launches == 0


def test_brute_nn_planted_tie_picks_first(rng):
    """Duplicated database rows score identically in any order: the first
    index wins, in the twin and in the Pallas kernel across tiles."""
    q = make_cloud8(rng, 64)
    db = make_cloud8(rng, 256)
    db[200] = db[17]   # across tiles of 64
    db[40] = db[33]    # within one tile
    q[:8] = db[17]
    q[8:16] = db[33]
    args = _weighted(q, db)
    i_p, _ = brute_nn_pallas(*map(jnp.asarray, args), tq=32, td=64, interpret=True)
    idx, _ = TB.brute_nn(*map(_t, args))
    np.testing.assert_array_equal(idx.numpy()[:8], 17)
    np.testing.assert_array_equal(idx.numpy()[8:16], 33)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_p))


@pytest.mark.parametrize("m, n", [(37, 101), (300, 1500)])
def test_brute_nn_twin_is_lane_order_argmin(rng, m, n):
    """Any m and n (no tile multiples): the twin's scores are the lane-order
    float32 scores bitwise, its index their first argmin, for any chunk."""
    args = _weighted(make_cloud8(rng, m), make_cloud8(rng, n))
    want = _lane_order_scores(*args)
    for chunk in (TB.REF_CHUNK, 7):
        idx, score = TB.brute_nn_ref(*map(_t, args), chunk=chunk)
        np.testing.assert_array_equal(idx.numpy(), want.argmin(1))
        np.testing.assert_array_equal(score.numpy(), want.min(1))


def test_nearest_neighbor_brute_matches_jax(rng):
    """Against the XLA baseline and the Pallas route: idx equal, distances
    at test_brute_pallas.py's bound."""
    q = make_cloud8(rng, 256)
    db = make_cloud8(rng, 512)
    q[5:9] = 0.0  # zero-geometry queries still get a neighbour
    ref_idx, ref_d = JD.nearest_neighbor_brute(jnp.asarray(q), jnp.asarray(db),
                                               jnp.float32(ALPHA))
    pal_idx, pal_d = nearest_neighbor_brute_pallas(jnp.asarray(q), jnp.asarray(db),
                                                   jnp.float32(ALPHA), interpret=True)
    idx, d = TD.nearest_neighbor_brute(_t(q), _t(db), ALPHA)
    assert idx.dtype == torch.int32
    for want_idx, want_d in ((ref_idx, ref_d), (pal_idx, pal_d)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-4, atol=1.0)
    assert (d.numpy() >= 0).all()


def test_point_sq_dists_matches_jax(rng):
    a = make_cloud8(rng, 300)
    b = make_cloud8(rng, 300)
    want = np.asarray(JD.point_sq_dists(jnp.asarray(a), jnp.asarray(b),
                                        jnp.float32(ALPHA)))
    got = TD.point_sq_dists(_t(a), _t(b), ALPHA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
