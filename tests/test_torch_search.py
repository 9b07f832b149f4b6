"""The unfused RBC search of the port against icp_tpu on the same numpy
inputs: the K5 twin (``bin_search_ref``) against the Pallas kernel in
interpret mode and the XLA branch, the grouped and original-order searches,
the K1′ twin (``rep_assign_ref``) and the member-table grouping.

On the CPU every wrapper takes its twin; the kernels themselves are checked
on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels import fused_step as JF
from icp_tpu.kernels.bin_search import bin_search_pallas
from icp_tpu.ops import distance as JD
from icp_tpu.rbc import construct as JC
from icp_tpu.rbc import grouping as JG
from icp_tpu.rbc import search as JR
from __graft_entry__ import _synthetic_pair
from icp_tpu_torch.interop import index_from_numpy
from icp_tpu_torch.kernels import fused_step as TF
from icp_tpu_torch.rbc import grouping as TG
from icp_tpu_torch.rbc import search as TR
from tests.utils import make_cloud8, random_quat

# The module, not the wrapper the package exports under its name.
TB = importlib.import_module("icp_tpu_torch.kernels.bin_search")

ALPHA = 150.0
W8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _search_inputs(rng, v, n_r=8, cq=24, cb=32):
    """Weighted rep-centered queries, rep-centered bins with masked slots,
    an empty bin (bin 2: every slot +inf) and a V-wide payload."""
    qc = np.zeros((n_r, cq, 8), np.float32)
    qc[..., :3] = rng.normal(size=(n_r, cq, 3)) * 20
    qc[..., 4:7] = rng.uniform(-0.5, 0.5, (n_r, cq, 3))
    bins_c = np.zeros((n_r, cb, 8), np.float32)
    bins_c[..., :3] = rng.normal(size=(n_r, cb, 3)) * 20
    bins_c[..., 4:7] = rng.uniform(-0.5, 0.5, (n_r, cb, 3))
    sq_b = np.sum(bins_c * W8 * bins_c, axis=-1).astype(np.float32)
    sq_b[rng.uniform(size=sq_b.shape) < 0.3] = np.inf
    sq_b[2] = np.inf
    vals = (rng.normal(size=(n_r, cb, v)) * 1000).astype(np.float32)
    return (qc * W8).astype(np.float32), bins_c, sq_b, vals


@pytest.mark.parametrize("v", [8, 12])
def test_bin_search_twin_matches_pallas(rng, v):
    """Slots and payloads equal the interpret-mode kernel's; the scores
    differ only by the order of the bf16x3 partial sums (<= 1 ulp)."""
    args = _search_inputs(rng, v)
    s_p, m_p = map(np.asarray, bin_search_pallas(*map(jnp.asarray, args),
                                                 interpret=True))
    s_t, m_t = TB.bin_search(*map(_t, args))
    assert s_t.shape == s_p.shape and m_t.shape == m_p.shape
    fin = np.isfinite(s_p)
    np.testing.assert_array_equal(np.isfinite(s_t.numpy()), fin)
    np.testing.assert_allclose(s_t.numpy()[fin], s_p[fin], rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(m_t.numpy(), m_p)
    assert TB.bin_search.launches == 0


def test_bin_search_empty_bin_returns_inf_and_slot_zero(rng):
    """A bin with no valid slot: +inf and slot 0's finite payload, as
    ``argmin`` of an all-+inf row (a NaN here would survive the masking)."""
    qg_w, bins_c, sq_b, vals = _search_inputs(rng, 12)
    s_t, m_t = TB.bin_search_ref(*map(_t, (qg_w, bins_c, sq_b, vals)))
    assert torch.isinf(s_t[2]).all()
    np.testing.assert_array_equal(m_t[2].numpy(),
                                  np.broadcast_to(vals[2, 0], m_t[2].shape))
    assert torch.isfinite(m_t).all()


def test_bin_search_twin_blocks_equal_whole(rng, monkeypatch):
    """The twin's blocking over bins does not change a bit."""
    args = tuple(map(_t, _search_inputs(rng, 8)))
    whole = TB.bin_search_ref(*args)
    monkeypatch.setattr(TB, "REF_BLOCK_ELEMS", 1)
    for a, b in zip(TB.bin_search_ref(*args), whole):
        assert torch.equal(a, b)


def _index_pair(rng, n=2048, n_r=32, cb=128, with_normals=False):
    """(JAX index, the same index carried to the port, queries) on the
    benchmark's surface pair: the fixed cloud (some points zeroed) and the
    moving cloud as the first ICP step sees it. Landmarks on a surface keep
    each bin ~100 mm wide, as at the flagship density; in a volume-filling
    cloud |q|^2_w ~ 1e5 would enter the cancellation best + |q|^2 and its
    float32 summation order (a few ulp of 1e5) would pass the bound."""
    db, queries = _synthetic_pair(n, seed=int(rng.integers(1 << 16)))
    db[7:19] = 0.0  # zero-geometry database points
    reps = db[rng.choice(np.arange(20, n), n_r, replace=False)]
    normals = None
    if with_normals:
        normals = rng.normal(size=(n, 3)).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    jidx = JC.rbc_construct(jnp.asarray(db), jnp.asarray(reps), jnp.float32(ALPHA),
                            cb, normals=None if normals is None else jnp.asarray(normals))
    return jidx, index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu"), queries


@pytest.mark.parametrize("cq, with_normals", [(96, False), (40, False), (96, True)])
def test_rbc_search_grouped_matches_jax(rng, cq, with_normals):
    """At test_pallas_kernels.py's bounds; cq 40 overflows the query
    capacity, so some queries are dropped."""
    jidx, tidx, queries = _index_pair(rng, with_normals=with_normals)
    extra = (rng.normal(size=(len(queries), 3)).astype(np.float32)
             if with_normals else None)
    want = JR.rbc_search_grouped(jidx, jnp.asarray(queries), jnp.float32(ALPHA), cq,
                                 use_pallas=False, with_normals=with_normals,
                                 extra_rows=None if extra is None else jnp.asarray(extra))
    got = TR.rbc_search_grouped(tidx, _t(queries), ALPHA, cq,
                                with_normals=with_normals,
                                extra_rows=None if extra is None else _t(extra))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert int(got.n_dropped) == int(want.n_dropped)
    assert got.n_dropped.dim() == 0 and isinstance(got.n_dropped, torch.Tensor)
    if cq == 40:
        assert int(got.n_dropped) > 0
    np.testing.assert_allclose(got.dist_g.numpy()[v], np.asarray(want.dist_g)[v],
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got.matched_g.numpy()[v],
                               np.asarray(want.matched_g)[v], atol=1e-5)
    np.testing.assert_array_equal(got.queries_g.numpy()[v],
                                  np.asarray(want.queries_g)[v])
    np.testing.assert_array_equal(got.matched_normals.numpy()[v],
                                  np.asarray(want.matched_normals)[v])
    assert got.extra_g.shape == want.extra_g.shape
    np.testing.assert_array_equal(got.extra_g.numpy()[v], np.asarray(want.extra_g)[v])


def test_rbc_search_grouped_pallas_route_agrees(rng):
    """The JAX package's Pallas route (interpret mode) and the port agree
    on the same bounds: the port's twin is the kernel's golden."""
    jidx, tidx, queries = _index_pair(rng)
    want = JR.rbc_search_grouped(jidx, jnp.asarray(queries), jnp.float32(ALPHA), 96,
                                 use_pallas=True, interpret=True)
    got = TR.rbc_search_grouped(tidx, _t(queries), ALPHA, 96)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.dist_g.numpy()[v], np.asarray(want.dist_g)[v],
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(got.matched_g.numpy()[v],
                                  np.asarray(want.matched_g)[v])


@pytest.mark.parametrize("m, n_r", [(1024, 16), (4096, 64)])
def test_rep_assign_twin_matches_jax_and_k1(rng, m, n_r):
    moving = make_cloud8(rng, m)
    reps = make_cloud8(rng, n_r)
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    G, b_row = JF.prep_similarity(jnp.asarray(q), jnp.asarray(t), jnp.float32(1.003))
    C, srow = JF.prep_rep_assign(jnp.asarray(reps), jnp.float32(ALPHA), G, b_row)
    want = np.asarray(JF.rep_assign_ref(jnp.asarray(moving), C, srow))
    pal = np.asarray(JF.rep_assign_pallas(jnp.asarray(moving), C, srow,
                                          interpret=True))
    rid = TF.rep_assign(_t(moving), _t(C), _t(srow))
    assert rid.dtype == torch.int32
    np.testing.assert_array_equal(rid.numpy(), want)
    np.testing.assert_array_equal(rid.numpy(), pal)
    rid_k1, _ = TF.rep_assign_counts_ref(_t(moving), _t(C), _t(srow))
    assert torch.equal(rid, rid_k1)
    assert TF.rep_assign.launches == 0


def test_rbc_point_assign_matches_jax(rng):
    jidx, tidx, moving = _index_pair(rng)
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    j_rid, j_G, j_b = JR.rbc_point_assign(jidx, jnp.asarray(moving), jnp.asarray(q),
                                          jnp.asarray(t), jnp.float32(1.0),
                                          jnp.float32(ALPHA), use_pallas=False)
    rid, G, b_row = TR.rbc_point_assign(tidx, _t(moving), _t(q), _t(t),
                                        torch.tensor(1.0), ALPHA)
    np.testing.assert_array_equal(rid.numpy(), np.asarray(j_rid))
    np.testing.assert_allclose(G.numpy(), np.asarray(j_G), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b_row.numpy(), np.asarray(j_b))
    assert G.is_contiguous()


@pytest.mark.parametrize("n, n_bins, cap", [
    (1000, 16, 64),    # typical occupancy
    (1000, 16, 40),    # capacity overflow
    (4096, 64, 96),
    (300, 40, 16),     # empty bins, the last ones included
])
def test_group_by_bin_gather_and_overflow_match_jax(rng, n, n_bins, cap):
    ids = rng.integers(0, n_bins - 3, n).astype(np.int32)
    rows = rng.normal(size=(n, 11)).astype(np.float32)
    j = JG.group_by_bin(jnp.asarray(ids), n_bins, cap)
    t = TG.group_by_bin(_t(ids), n_bins, cap)
    for name in ("order", "counts", "offsets", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.member.numpy()[v], np.asarray(j.member)[v])
    assert t.order.dtype == t.member.dtype == torch.int32
    got = TG.gather_grouped(t, _t(rows)).numpy()
    want = np.asarray(JG.gather_grouped(j, jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[v], rows[np.asarray(j.member)[v]])
    ov = TG.overflow_mask(t, _t(ids), cap).numpy()
    np.testing.assert_array_equal(ov, np.asarray(JG.overflow_mask(j, jnp.asarray(ids),
                                                                  cap)))
    assert ov.sum() == n - v.sum()


@pytest.mark.parametrize("cq", [96, 40])
def test_rbc_search_matches_jax(rng, cq):
    """Original-order search: ids, representatives and fallbacks equal;
    matched distances at the grouped search's bounds, fallback distances
    (query to representative) at test_torch_rbc.py's pairwise bound, the
    float32 ulp of the largest query-rep d2. cq 40 overflows more bins."""
    jidx, tidx, queries = _index_pair(rng)
    want = JR.rbc_search(jidx, jnp.asarray(queries), jnp.float32(ALPHA), cq)
    got = TR.rbc_search(tidx, _t(queries), ALPHA, cq)
    for name in ("nn_id", "query_rep", "fallback"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    fb = np.asarray(want.fallback)
    got_d, want_d = got.nn_dist.numpy(), np.asarray(want.nn_dist)
    np.testing.assert_allclose(got_d[~fb], want_d[~fb], rtol=1e-5, atol=1e-2)
    d2_qr = np.asarray(JD.pairwise_sq_dists(jnp.asarray(queries), jidx.reps,
                                            jnp.float32(ALPHA)))
    np.testing.assert_allclose(got_d[fb], want_d[fb], rtol=1e-5,
                               atol=2e-7 * d2_qr.max())
    assert fb.any()  # the fallback path ran
