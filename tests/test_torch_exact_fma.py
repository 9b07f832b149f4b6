"""Why the K1, K3 and K9 kernels may score with fused multiply-adds and K3
may skip the dead slots of a bin, checked on the plain twins on the CPU.

- Every product of a bf16x3 score (hi.hi, hi.lo, lo.hi) is exact in
  float32, so an FMA chain (one rounding per lane, ``dot3_8_fma`` in
  ``icp_tpu_torch/csrc/common.cuh``) equals the twin's separate multiply
  and add (``fused_step.dot3``) bit for bit. The chain is emulated in
  float64: a step rounds ``float64(acc) + float64(a) * float64(b)`` once to
  float32, the single rounding of an FMA for these operands. K9 scores raw,
  uncentred 3-D points (z ~ 1500 mm at the LiDAR shape) against Morton
  representatives: its 3-lane chains are held on those operands too.
- Cutting each bin at its last live ``sq_b_masked`` slot and dropping the
  query slots with ``qvalid == 0`` (what K3 searches) leaves each kept
  slot's best score and slot bitwise, and P as it was.
- ``icp_tpu_torch.sensors.synthetic.synthetic_pair`` is
  ``__graft_entry__._synthetic_pair``, bit for bit.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair
from icp_tpu_torch import ICPConfig, ICPParams
from icp_tpu_torch.icp.run import build_index
from icp_tpu_torch.icp.state import identity_state
from icp_tpu_torch.kernels import fused_step as fs
from icp_tpu_torch.ops.distance import metric_weights
from icp_tpu_torch.ops.normals import _morton_order
from icp_tpu_torch.rbc.grouping import group_rows_by_bin
from icp_tpu_torch.sensors import knn_sets
from icp_tpu_torch.sensors.synthetic import synthetic_pair, wavy_surface_pair

ALPHA = 2e2  # the benchmark's blend


def _first_iteration(name):
    """K1's (moving8, C, srow) and K3's arguments at the first iteration of
    the flagship pair (16384 x 256), of a 4096-point wavy-surface pair (64
    reps), or of the flagship pair with bin 5 fully masked and bin 7 given
    more queries than its capacity ("edge")."""
    if name == "wavy4096":
        fixed, moving = (torch.from_numpy(a) for a in wavy_surface_pair(4096)[:2])
        cfg = ICPConfig(m=4096, n_r=64)
    else:
        fixed, moving = (torch.from_numpy(a) for a in synthetic_pair(16384))
        cfg = ICPConfig()
    params = ICPParams(alpha=ALPHA)
    index = build_index(fixed, params, cfg)
    st = identity_state(torch.float32, torch.device("cpu"))
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    alpha = torch.tensor(ALPHA)
    C, srow = fs.prep_rep_assign(index.reps, alpha, G, b_row)
    rid, _ = fs.rep_assign_counts_ref(moving, C, srow)
    sq_b = index.sq_b_masked.clone()
    if name == "edge":
        rid = rid.clone()
        rid[:500] = 7
        sq_b[5] = float("inf")
    gl = group_rows_by_bin(rid, cfg.n_r, cfg.query_capacity, (moving,))
    k3 = (gl.grouped[0], gl.valid.to(torch.float32), index.reps, index.bins_centered,
          sq_b, G, b_row, alpha)
    return (moving, C, srow), k3


@pytest.fixture(scope="module")
def cases():
    return ({name: _first_iteration(name) for name in ("flagship", "wavy4096", "edge")}
            | {name: _k9_case(name) for name in K9_CASES})


K9_CASES = ("lidar", "16384", "normal", "ties")


def _halves(x):
    hi = fs._bf16_round(x)
    return hi, fs._bf16_round(x - hi)


def _k1_operands(case):
    (moving8, C, _), _ = case
    return moving8[:, None, :], C.T[None, :, :]


def _k9_case(name):
    """K9's (p, reps): raw wavy-surface points against their Morton reps, as
    the estimator picks them, at the LiDAR shape (every 256th of the 262144
    points against all 2048 reps) and the GICP "knn_rbc" cell's 16384
    points (128 reps); or the "normal" and "ties" sets of
    ``sensors.knn_sets.top2``."""
    if name in knn_sets.TOP2:
        return tuple(torch.from_numpy(x) for x in knn_sets.top2(name))
    m, n_r, step = {"lidar": (262144, 2048, 256), "16384": (16384, 128, 1)}[name]
    p = torch.from_numpy(wavy_surface_pair(m)[0][:, :3].copy())
    stride = m // n_r
    reps = p[_morton_order(p)[stride // 2::stride][:n_r].long()]
    return p[::step].contiguous(), reps


def _k9_operands(case):
    p, reps = case
    return p[:, None, :], reps[None, :, :]


def _operands(cases, name, kernel):
    if kernel == "K9":
        return _k9_operands(cases[name])
    return (_k1_operands if kernel == "K1" else _k3_operands)(cases[name])


def _k3_operands(case):
    _, (mg, qvalid, reps, bins_c, sq_b, G, b_row, alpha) = case
    qc = fs.search_ref(mg, qvalid, reps, bins_c, sq_b, G, b_row, alpha)[0]
    qg_w = qc * metric_weights(alpha)
    return qg_w[:, :, None, :], bins_c[:, None, :, :8]


@pytest.mark.parametrize("name, kernel", [("flagship", "K1"), ("wavy4096", "K1"),
                                          ("flagship", "K3")]
                         + [(name, "K9") for name in K9_CASES])
def test_bf16_part_products_are_exact(cases, name, kernel):
    """hi.hi, hi.lo and lo.hi products of the score operands: the float32
    product equals the float64 product on every (query, candidate, lane)."""
    a, b = _operands(cases, name, kernel)
    a_hi, a_lo = _halves(a)
    b_hi, b_lo = _halves(b)
    nonzero = 0
    for x, y in ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)):
        for k in range(a.shape[-1]):
            p32 = x[..., k] * y[..., k]
            p64 = x[..., k].double() * y[..., k].double()
            assert torch.equal(p32.double(), p64), (kernel, name, k)
            nonzero += int((p32 != 0).sum())
    assert nonzero > 0


def _fma_chain(x, y):
    """One float32 multiply, then an FMA a lane in lane order (seven over 8
    lanes, two over 3), each emulated as one rounding of the float64 value."""
    acc = (x[..., 0].double() * y[..., 0].double()).float()
    for k in range(1, x.shape[-1]):
        acc = (acc.double() + x[..., k].double() * y[..., k].double()).float()
    return acc


def _dot3_fma(a, b):
    a_hi, a_lo = _halves(a)
    b_hi, b_lo = _halves(b)
    return (_fma_chain(a_hi, b_hi) + _fma_chain(a_hi, b_lo)) + _fma_chain(a_lo, b_hi)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name, kernel", [("flagship", "K1"), ("wavy4096", "K1"),
                                          ("flagship", "K3"), ("edge", "K3")]
                         + [(name, "K9") for name in K9_CASES])
def test_fma_chain_equals_the_twin_bitwise(cases, name, kernel):
    """dot3_8_fma's chain (K9: a 3-lane chain of one multiply and two FMAs)
    and score_fma's single rounding give the twin's dot3 and score bit for
    bit (and so the same first minimum)."""
    a, b = _operands(cases, name, kernel)
    if kernel == "K1":
        s = cases[name][0][2]
    elif kernel == "K9":
        reps = cases[name][1]
        s = fs.lane_dot(reps, reps)[None, :]  # srow = |r|^2, as the wrapper makes it
    else:
        s = cases[name][1][4][:, None, :]
    cross_twin = fs.dot3(a, b)
    cross_fma = _dot3_fma(a, b)
    assert torch.equal(_bits(cross_fma), _bits(cross_twin))
    score_twin = s - 2.0 * cross_twin
    score_fma = (s.double() - 2.0 * cross_fma.double()).float()
    assert torch.equal(_bits(score_fma), _bits(score_twin))
    assert torch.equal(torch.argmin(score_fma, dim=-1), torch.argmin(score_twin, dim=-1))


def _cut_search(qg_w, bins_c, sq_b, qvalid):
    """K3's search: each bin cut after its last slot that is not +inf or
    NaN, query slots with qvalid == 0 dropped. Returns (best, slot, kept,
    live counts) with dropped slots at (+inf, 0)."""
    n_r, cq = qvalid.shape
    best = torch.full((n_r, cq), float("inf"))
    slot = torch.zeros((n_r, cq), dtype=torch.long)
    kept = qvalid != 0
    live_n = torch.zeros(n_r, dtype=torch.long)
    for b in range(n_r):
        live = torch.nonzero(sq_b[b] < float("inf"))[:, 0]
        n_live = int(live[-1]) + 1 if live.numel() else 0
        live_n[b] = n_live
        q = torch.nonzero(kept[b])[:, 0]
        if n_live == 0 or q.numel() == 0:
            continue
        scores = sq_b[b, None, :n_live] - 2.0 * fs.dot3(qg_w[b, q, None, :],
                                                        bins_c[b, None, :n_live, :8])
        best[b, q], slot[b, q] = torch.min(scores, dim=-1)
    return best, slot, kept, live_n


@pytest.mark.parametrize("name", ["flagship", "wavy4096", "edge"])
def test_live_cut_leaves_the_search_and_P(cases, name):
    """On the twin: the cut search gives every kept slot's best score and
    slot bitwise, and P rebuilt from it (dropped slots weigh 0) is within
    1e-6 of max|P| of bin_point_moments_ref's."""
    _, args = cases[name]
    mg, qvalid, reps, bins_c, sq_b, G, b_row, alpha = args
    qc, best_t, slot_t, sq_q, valid0 = fs.search_ref(*args)
    best, slot, kept, live_n = _cut_search(qc * metric_weights(alpha), bins_c, sq_b, qvalid)
    cb = bins_c.shape[1]
    assert int((live_n < cb).sum()) > 0 and int((~kept).sum()) > 0  # the cut bites
    assert torch.equal(_bits(best[kept]), _bits(best_t[kept]))
    assert torch.equal(slot[kept], slot_t[kept])
    w = fs.match_weights_ref(best, sq_q, valid0, weighted=True)
    w = torch.where(kept, w, torch.zeros_like(w))
    matched = torch.gather(bins_c, 1, slot[..., None].expand(-1, -1, 8))
    ones = torch.ones_like(qc[..., :1])
    u = torch.cat([qc[..., :3], ones, matched[..., :3], ones], dim=-1)
    P = torch.einsum("bqi,bqj->bij", u * w[..., None], u)
    P_t = fs.bin_point_moments_ref(*args, weighted=True)
    assert float((P - P_t).abs().max()) <= 1e-6 * float(P_t.abs().max())
    if name == "edge":
        assert int(live_n[5]) == 0 and bool((P_t[5] == 0).all())
        assert bool(kept[7].all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_pair_is_the_graft_entry_pair(seed):
    ours = synthetic_pair(16384, seed=seed)
    theirs = _synthetic_pair(16384, seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
