"""The plain twins of the port's three CUDA kernels, and the host side of
``icp_tpu_torch.kernels.fused_step``, against icp_tpu on the same numpy
inputs. The JAX side runs as its own tests run it: the XLA twin and the
Pallas kernel in interpret mode.

On the CPU every wrapper takes its twin, so these tests also hold the
wrappers' CPU dispatch; the kernels themselves are checked on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels import fused_step as JF
from icp_tpu.kernels import table_build as JT
from icp_tpu_torch.kernels import fused_step as TF
from icp_tpu_torch.kernels import table_build as TT
from tests.utils import make_cloud8, random_quat

ALPHA = 150.0


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, copy=True))


def _state(rng):
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    return q, t, np.float32(1.003)


def _assign_inputs(rng, m, n_r):
    """Raw moving rows and the folded (C, srow) of a random state, built
    by the JAX package (the module under test starts from its output)."""
    moving = make_cloud8(rng, m)
    reps = make_cloud8(rng, n_r)
    q, t, s = _state(rng)
    G, b_row = JF.prep_similarity(jnp.asarray(q), jnp.asarray(t), jnp.float32(s))
    C, srow = JF.prep_rep_assign(jnp.asarray(reps), jnp.float32(ALPHA), G, b_row)
    return moving, np.asarray(C), np.asarray(srow)


@pytest.mark.parametrize("m, n_r", [(1024, 16), (4096, 64)])
def test_rep_assign_counts_twin_matches_jax(rng, m, n_r):
    moving, C, srow = _assign_inputs(rng, m, n_r)
    rid_r, counts_r = JF.rep_assign_counts_ref(jnp.asarray(moving),
                                               jnp.asarray(C), jnp.asarray(srow))
    rid_p, counts_p = JF.rep_assign_counts_pallas(
        jnp.asarray(moving), jnp.asarray(C), jnp.asarray(srow), interpret=True)
    rid, counts = TF.rep_assign_counts(_t(moving), _t(C), _t(srow))
    assert rid.dtype == torch.int32 and counts.dtype == torch.int32
    for jr, jc in ((rid_r, counts_r), (rid_p, counts_p)):
        np.testing.assert_array_equal(rid.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert int(counts.sum()) == m
    assert TF.rep_assign_counts.launches == 0


def test_rep_assign_first_min_tie_break():
    """Exactly tied scores pick the smallest representative id."""
    moving = np.zeros((4, 8), np.float32)
    C = np.zeros((8, 5), np.float32)
    srow = np.array([[3.0, 1.0, 1.0, 2.0, 1.0]], np.float32)
    rid, counts = TF.rep_assign_counts(_t(moving), _t(C), _t(srow))
    np.testing.assert_array_equal(rid.numpy(), [1, 1, 1, 1])
    np.testing.assert_array_equal(counts.numpy(), [0, 4, 0, 0, 0])


def _table_inputs(rng, m, n_r, d, cap):
    ids = rng.integers(0, n_r, m).astype(np.int32)
    ids[ids == 1] = 2  # an empty bin
    counts = np.bincount(ids, minlength=n_r)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    rows = rng.normal(size=(m, d)).astype(np.float32)
    return rows[np.argsort(ids, kind="stable")], starts


@pytest.mark.parametrize("m, n_r, d, cap", [(1024, 16, 8, 96), (4096, 64, 9, 128),
                                            (300, 8, 8, 64)])
def test_bin_table_twin_bitwise_matches_jax(rng, m, n_r, d, cap):
    sorted_rows, starts = _table_inputs(rng, m, n_r, d, cap)
    ref = np.asarray(JT.bin_table_ref(jnp.asarray(sorted_rows),
                                      jnp.asarray(starts), capacity=cap))
    got = TT.bin_table(_t(sorted_rows), _t(starts), capacity=cap).numpy()
    assert got.shape == (n_r, cap, d)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    if d == 8:  # the Pallas kernel's own tests run it on 8-lane rows
        pal = np.asarray(JT.bin_table_pallas(jnp.asarray(sorted_rows),
                                             jnp.asarray(starts), capacity=cap,
                                             interpret=True))
        np.testing.assert_array_equal(got.view(np.int32), pal.view(np.int32))
    # Slots past the last row are exact zeros, not garbage.
    last = int(starts[-1])
    assert last + cap > m
    np.testing.assert_array_equal(got[-1, m - last:], 0.0)
    assert TT.bin_table.launches == 0


def _moment_inputs(rng, n_r=8, cq=24, cb=32):
    """Grouped raw queries near their reps, rep-centered bins with masked
    slots, an empty bin (bin 2: every slot +inf) and zero-geometry rows."""
    reps = make_cloud8(rng, n_r)
    mg = np.repeat(reps[:, None, :], cq, axis=1)
    mg[..., :3] += rng.normal(size=(n_r, cq, 3)) * 20
    mg[..., 4:7] = rng.uniform(0, 1, (n_r, cq, 3))
    mg[0, :5] = 0.0  # zero-geometry (invalid sensor) query rows
    qvalid = (rng.uniform(size=(n_r, cq)) < 0.85).astype(np.float32)
    bins_c = np.zeros((n_r, cb, 8), np.float32)
    bins_c[..., :3] = rng.normal(size=(n_r, cb, 3)) * 20
    bins_c[..., 4:7] = rng.uniform(-0.5, 0.5, (n_r, cb, 3))
    w8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)
    sq_b = np.sum(bins_c * w8 * bins_c, axis=-1).astype(np.float32)
    sq_b[rng.uniform(size=sq_b.shape) < 0.3] = np.inf
    sq_b[2] = np.inf
    q, t, s = _state(rng)
    G, b_row = JF.prep_similarity(jnp.asarray(q), jnp.asarray(t), jnp.float32(s))
    return (mg.astype(np.float32), qvalid, reps, bins_c, sq_b,
            np.asarray(G), np.asarray(b_row))


@pytest.mark.parametrize("weighted", [True, False])
def test_bin_point_moments_twin_matches_jax(rng, weighted):
    args = _moment_inputs(rng)
    j_args = tuple(map(jnp.asarray, args)) + (jnp.float32(ALPHA),)
    ref = np.asarray(JF.bin_point_moments_ref(*j_args, weighted=weighted))
    pal = np.asarray(JF.bin_point_moments_pallas(*j_args, weighted=weighted,
                                                 interpret=True))
    got = TF.bin_point_moments(*map(_t, args), ALPHA, weighted=weighted).numpy()
    for want in (ref, pal):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # The empty bin and the invalid rows contribute nothing.
    np.testing.assert_array_equal(got[2], 0.0)
    assert TF.bin_point_moments.launches == 0


def test_bin_point_moments_alpha_tensor_equals_float(rng):
    args = tuple(map(_t, _moment_inputs(rng)))
    a = TF.bin_point_moments(*args, ALPHA, weighted=True)
    b = TF.bin_point_moments(*args, torch.tensor(ALPHA), weighted=True)
    assert torch.equal(a, b)


def test_prep_similarity_and_rep_assign_match_jax(rng):
    q, t, s = _state(rng)
    reps = make_cloud8(rng, 32)
    jG, jb = JF.prep_similarity(jnp.asarray(q), jnp.asarray(t), jnp.float32(s))
    G, b = TF.prep_similarity(_t(q), _t(t), torch.tensor(s))
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    jC, js = JF.prep_rep_assign(jnp.asarray(reps), jnp.float32(ALPHA), jG, jb)
    C, srow = TF.prep_rep_assign(_t(reps), ALPHA, G, b)
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=1e-5, atol=1e-3)
    # srow cancels ~1e6 terms: absolute tolerance at their float32 ulp.
    np.testing.assert_allclose(srow.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(js)).max())


def test_point_translation_tensor_matches_jax(rng):
    reps = make_cloud8(rng, 32)
    want = np.asarray(JF.point_translation_tensor(jnp.asarray(reps)))
    got = TF.point_translation_tensor(_t(reps)).numpy()
    assert got.shape == (32, 8, 8, 18)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_point_moment_partials_hoisted_equals_direct_and_jax(rng):
    """The W_t product equals the direct per-term algebra it was built from,
    and both equal the JAX package's (coefficients reach r*r ~ 4e6)."""
    reps = make_cloud8(rng, 32)
    P = (rng.normal(size=(32, 8, 8)) * 50.0).astype(np.float32)
    direct = TF.point_moment_partials(_t(P), _t(reps)).numpy()
    fast = TF.point_moment_partials(_t(P), _t(reps),
                                    TF.point_translation_tensor(_t(reps))).numpy()
    np.testing.assert_allclose(fast, direct, rtol=2e-5, atol=1e-2)
    want = np.asarray(JF.point_moment_partials(jnp.asarray(P), jnp.asarray(reps)))
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=1e-2)


def test_assemble_point_moments_matches_jax(rng):
    reps = make_cloud8(rng, 16)
    P = np.abs(rng.normal(size=(16, 8, 8)) * 30.0).astype(np.float32)
    want = JF.point_moments_from_P(jnp.asarray(P), jnp.asarray(reps), 1e-3)
    got = TF.point_moments_from_P(_t(P), _t(reps), 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)
    # Fully masked frame: no 0/0 reaches the means.
    S11, mf, mm, W = TF.point_moments_from_P(torch.zeros(16, 8, 8), _t(reps), 1e-3)
    assert float(W) == 0.0 and torch.isfinite(mf).all() and torch.isfinite(S11).all()
