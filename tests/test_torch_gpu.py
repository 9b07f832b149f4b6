"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; they skip where ``torch.cuda.is_available()`` is False.
The file imports neither jax nor the repo's conftest helpers, so on a
machine with a GPU and no jax it runs as

    python -m pytest tests/test_torch_gpu.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair

pytestmark = pytest.mark.cuda

M, N_R = 16384, 256


@pytest.fixture(scope="module")
def flagship():
    """First-iteration tensors of the flagship pair on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs

    dev = torch.device("cuda", 0)
    fixed, moving = (torch.from_numpy(a).to(dev) for a in _synthetic_pair(M))
    cfg = ICPConfig()
    params = ICPParams(alpha=2e2).to(dev)
    index = build_index(fixed, params, cfg)
    st = identity_state(torch.float32, dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    C, srow = fs.prep_rep_assign(index.reps, params.alpha, G, b_row)
    return dict(dev=dev, cfg=cfg, params=params, index=index, moving=moving,
                fixed=fixed, G=G.contiguous(), b_row=b_row, C=C.contiguous(),
                srow=srow)


def test_rep_assign_counts_kernel_matches_twin(flagship):
    from icp_tpu_torch.kernels import fused_step as fs

    f = flagship
    before = fs.rep_assign_counts.launches
    rid, counts = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    rid_t, counts_t = fs.rep_assign_counts_ref(f["moving"], f["C"], f["srow"])
    torch.cuda.synchronize()
    assert fs.rep_assign_counts.launches == before + 1
    assert torch.equal(counts, torch.bincount(rid, minlength=N_R).to(torch.int32))
    assert int(counts.sum()) == M
    # Same rounding as the twin (lane order, bf16x3): the same picks.
    assert torch.equal(rid, rid_t) and torch.equal(counts, counts_t)


def test_bin_table_kernel_bitwise(flagship):
    from icp_tpu_torch.kernels import table_build as tb

    f = flagship
    g = torch.Generator(device="cpu").manual_seed(0)
    for d, cap in ((8, f["cfg"].query_capacity), (9, f["cfg"].bin_capacity)):
        rows = torch.randn(M, d, generator=g).to(f["dev"])
        counts = torch.bincount(torch.randint(0, N_R, (M,), generator=g),
                                minlength=N_R).to(f["dev"])
        starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        got = tb.bin_table(rows, starts, capacity=cap)
        want = tb.bin_table_ref(rows, starts, capacity=cap)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("weighted", [True, False])
def test_bin_point_moments_kernel_matches_twin(flagship, weighted):
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin

    f = flagship
    rid, counts = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    gl = group_rows_by_bin(rid, N_R, f["cfg"].query_capacity, (f["moving"],),
                           counts=counts)
    args = (gl.grouped[0], gl.valid.to(torch.float32), f["index"].reps,
            f["index"].bins_centered, f["index"].sq_b_masked, f["G"],
            f["b_row"], f["params"].alpha)
    P = fs.bin_point_moments(*args, weighted=weighted)
    P_t = fs.bin_point_moments_ref(*args, weighted=weighted)
    torch.cuda.synchronize()
    assert float((P - P_t).abs().max()) <= 1e-4 * float(P_t.abs().max())
    assert torch.equal(P, fs.bin_point_moments(*args, weighted=weighted))


def test_register_on_card_matches_cpu(flagship):
    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    f = flagship
    st = register(f["fixed"], f["moving"], ICPParams(alpha=2e2), ICPConfig())
    cpu = register(f["fixed"].cpu(), f["moving"].cpu(), ICPParams(alpha=2e2),
                   ICPConfig())
    assert abs(int(st.k) - int(cpu.k)) <= 1
    assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.01
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.001


# ---- slice 2: K4, K7 and robust K3 on the rendered gate pair ---------------


@pytest.fixture(scope="module")
def rendered():
    """First-iteration tensors of bench.py's rendered gate pair on the card,
    with a PLANE index (normals, K7's payload) and the 11-wide grouped
    (moving8 | rotated normal) query table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from icp_tpu_torch import ICPConfig, ICPParams, Objective
    from icp_tpu_torch.icp.quaternion import qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.ops.normals import normals_for
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin
    from icp_tpu_torch.sensors import synthetic

    dev = torch.device("cuda", 0)
    scene = synthetic.default_scene()
    q_b = torch.tensor([0.0, np.sin(0.004), 0.0, np.cos(0.004)], dtype=torch.float32)
    pose_b = synthetic.CameraPose(q_b, torch.tensor([10.0, -6.0, 8.0]))
    fixed, moving = (get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8))
                     .contiguous() for p in (synthetic.CameraPose.identity(), pose_b))
    cfg = ICPConfig(objective=Objective.PLANE, estimate_scale=False)
    params = ICPParams(alpha=2e2).to(dev)
    fixed_d, moving_d = fixed.to(dev), moving.to(dev)
    index = build_index(fixed_d, params, cfg)
    st = identity_state(torch.float32, dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    G = G.contiguous()
    C, srow = fs.prep_rep_assign(index.reps, params.alpha, G, b_row)
    rid, counts = fs.rep_assign_counts(moving_d, C.contiguous(), srow)
    mnr = qrotate(st.q, normals_for(moving_d, "auto"))
    gl = group_rows_by_bin(rid, N_R, cfg.query_capacity, (moving_d, mnr), counts=counts)
    search = (index.reps, index.bins_centered, index.sq_b_masked, G, b_row, params.alpha)
    return dict(dev=dev, cfg=cfg, params=params, index=index, fixed=fixed,
                moving=moving, fixed_d=fixed_d, moving_d=moving_d, mg=gl.grouped[0],
                nm=gl.grouped[1], qvalid=gl.valid.to(torch.float32), search=search)


def test_bin_min_dists_kernel_matches_twin(rendered):
    from icp_tpu_torch.kernels import fused_step as fs

    r = rendered
    args = (r["mg"], r["qvalid"]) + r["search"]
    before = fs.bin_min_dists.launches
    got = fs.bin_min_dists(*args)  # strided rows of the 11-wide table
    want = fs.bin_min_dists_ref(*args)
    torch.cuda.synchronize()
    assert fs.bin_min_dists.launches == before + 1
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-6 * float(want[fin].max())


@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
def test_bin_gn_moments_kernel_matches_twin(rendered, mode):
    from icp_tpu_torch.kernels import fused_gn as fg

    r = rendered
    args = (r["mg"], None if mode == "plane" else r["nm"], r["qvalid"],
            r["index"].reps, r["index"].bins_vals12, r["index"].sq_b_masked,
            *r["search"][3:])
    kw = dict(mode=mode, weighted=True, gicp_eps=1e-3)
    got = fg.bin_gn_moments(*args, **kw)
    want = fg.bin_gn_moments_ref(*args, **kw)
    again = fg.bin_gn_moments(*args, **kw)
    torch.cuda.synchronize()
    if mode != "gicp":
        got, want, again = (got,), (want,), (again,)
    for g, w, a in zip(got, want, again):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        assert torch.equal(g, a)  # the fixed-order reduction repeats bitwise


@pytest.mark.parametrize("robust, weighted", [("huber", True), ("trimmed", False),
                                              ("tukey", True)])
def test_bin_point_moments_robust_kernel_matches_twin(rendered, robust, weighted):
    from icp_tpu_torch.kernels import fused_step as fs

    r = rendered
    args = (r["mg"].contiguous(), r["qvalid"]) + r["search"]
    kw = dict(weighted=weighted, robust=robust, robust_delta=12.0)
    got = fs.bin_point_moments(*args, **kw)
    want = fs.bin_point_moments_ref(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_plane_register_on_card_matches_cpu(rendered):
    from icp_tpu_torch import ICPParams, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    r = rendered
    st = register(r["fixed_d"], r["moving_d"], ICPParams(alpha=2e2), r["cfg"])
    cpu = register(r["fixed"], r["moving"], ICPParams(alpha=2e2), r["cfg"])
    assert abs(int(st.k) - int(cpu.k)) <= 1
    assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.05
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.005


# ---- slices 3 and 4: K1′, K5 and K6 -----------------------------------------


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def test_rep_assign_kernel_matches_twin_and_k1(flagship):
    from icp_tpu_torch.kernels import fused_step as fs

    f = flagship
    before = fs.rep_assign.launches
    rid = fs.rep_assign(f["moving"], f["C"], f["srow"])
    rid_t = fs.rep_assign_ref(f["moving"], f["C"], f["srow"])
    rid_k1, _ = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    torch.cuda.synchronize()
    assert fs.rep_assign.launches == before + 1
    assert rid.dtype == torch.int32
    assert torch.equal(rid, rid_t) and torch.equal(rid, rid_k1)


def _search_tensors(dev, n_r, cq, cb, v, seed=0):
    """Weighted rep-centered queries and bins at bin-like magnitudes, ~30 %
    masked slots, bin 1 empty (every slot +inf), and a V-wide payload."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w8 = torch.tensor([1, 1, 1, 0, 200, 200, 200, 0], dtype=torch.float32)
    qc = torch.randn(n_r, cq, 8, generator=g) * torch.tensor([40, 40, 40, 0, .3, .3, .3, 1])
    bins_c = torch.randn(n_r, cb, 8, generator=g) * torch.tensor([40, 40, 40, 0, .3, .3, .3, 1])
    sq_b = torch.sum(bins_c * w8 * bins_c, dim=-1)
    sq_b[torch.rand(n_r, cb, generator=g) < 0.3] = float("inf")
    sq_b[1] = float("inf")
    vals = torch.randn(n_r, cb, v, generator=g) * 1000
    return tuple(x.contiguous().to(dev) for x in (qc * w8, bins_c, sq_b, vals))


@pytest.mark.parametrize("n_r, cq, cb, v", [(256, 96, 128, 8), (256, 96, 128, 12),
                                            (16, 1536, 2048, 8), (16, 1536, 2048, 12),
                                            (3, 200, 700, 8)])
def test_bin_search_kernel_bitwise(cuda_dev, n_r, cq, cb, v):
    """K5 against its twin: the same scores and payloads bitwise, from the
    flagship capacities (cq 96, cb 128) to m 16384 over 16 bins (cb 2048,
    several shared-memory tiles per bin) and capacities off any tile size."""
    from icp_tpu_torch.kernels import bin_search as bs

    args = _search_tensors(cuda_dev, n_r, cq, cb, v)
    before = bs.bin_search.launches
    best, matched = bs.bin_search(*args)
    best_t, matched_t = bs.bin_search_ref(*args)
    torch.cuda.synchronize()
    assert bs.bin_search.launches == before + 1
    assert torch.equal(best.view(torch.int32), best_t.view(torch.int32))
    assert torch.equal(matched.view(torch.int32), matched_t.view(torch.int32))
    assert torch.isinf(best[1]).all() and torch.isfinite(matched).all()


def test_bin_search_kernel_on_unfused_flagship_tables(flagship):
    """K5 on the grouped tables the unfused step builds at the flagship
    shape, bitwise against its twin."""
    from icp_tpu_torch.kernels import bin_search as bs
    from icp_tpu_torch.ops.distance import metric_weights, pairwise_sq_dists
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin

    f = flagship
    idx = f["index"]
    rep = torch.argmin(pairwise_sq_dists(f["moving"], idx.reps, f["params"].alpha), dim=1)
    gl = group_rows_by_bin(rep.to(torch.int32), N_R, f["cfg"].query_capacity, (f["moving"],))
    qg_w = ((gl.grouped[0] - idx.reps[:, None, :])
            * metric_weights(f["params"].alpha, device=f["dev"])).contiguous()
    args = (qg_w, idx.bins_centered.contiguous(), idx.sq_b_masked.contiguous(),
            idx.bins.contiguous())
    best, matched = bs.bin_search(*args)
    best_t, matched_t = bs.bin_search_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(best.view(torch.int32), best_t.view(torch.int32))
    assert torch.equal(matched.view(torch.int32), matched_t.view(torch.int32))


def _brute_tensors(dev, m, n, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    w8 = torch.tensor([1, 1, 1, 0, 200, 200, 200, 0], dtype=torch.float32)
    scale = torch.tensor([300, 300, 100, 0, .3, .3, .3, 1])
    q = torch.randn(m, 8, generator=g) * scale
    db = torch.randn(n, 8, generator=g) * scale
    return q, db, w8


@pytest.mark.parametrize("m, n", [(20, 500), (1000, 5000), (4097, 3000)])
def test_brute_nn_kernel_bitwise(cuda_dev, m, n):
    """K6 against its twin, one database tile and several, any m and n:
    the same index on every query and the same score bitwise."""
    from icp_tpu_torch.kernels import brute_nn as bn

    q, db, w8 = _brute_tensors(cuda_dev, m, n)
    qw, db, sq_db = ((q * w8).to(cuda_dev), db.to(cuda_dev),
                     torch.sum(db * w8 * db, dim=-1).to(cuda_dev))
    before = bn.brute_nn.launches
    idx, score = bn.brute_nn(qw, db, sq_db)
    idx_t, score_t = bn.brute_nn_ref(qw, db, sq_db)
    torch.cuda.synchronize()
    assert bn.brute_nn.launches == before + 1
    assert torch.equal(idx, idx_t)
    assert torch.equal(score.view(torch.int32), score_t.view(torch.int32))


def test_brute_nn_kernel_planted_tie_picks_first(cuda_dev):
    """Duplicated database rows tie exactly: the first index wins, across
    database tiles (1024 rows) and across the slices of one tile."""
    from icp_tpu_torch.kernels import brute_nn as bn

    q, db, w8 = _brute_tensors(cuda_dev, 64, 3000, seed=1)
    db[2500] = db[17]   # another tile
    db[300] = db[40]    # same tile, another slice
    q[:8] = db[17]
    q[8:16] = db[40]
    qw, db, sq_db = ((q * w8).to(cuda_dev), db.to(cuda_dev),
                     torch.sum(db * w8 * db, dim=-1).to(cuda_dev))
    idx, _ = bn.brute_nn(qw, db, sq_db)
    idx_t, _ = bn.brute_nn_ref(qw, db, sq_db)
    torch.cuda.synchronize()
    assert (idx[:8] == 17).all() and (idx[8:16] == 40).all()
    assert torch.equal(idx, idx_t)


@pytest.mark.parametrize("d", [{"correspondence": "brute"},
                               {"objective": "plane", "fused_gn": False,
                                "estimate_scale": False}])
def test_unfused_register_on_card_matches_cpu(rendered, d):
    """BRUTE POINT and unfused PLANE on the card against the CPU twins, on
    every fourth landmark of the rendered pair (the CPU twin of K6 sweeps
    the whole m x m set each step)."""
    from icp_tpu_torch import ICPParams, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.interop import config_from_dict

    r = rendered
    fixed, moving = r["fixed"][::4].contiguous(), r["moving"][::4].contiguous()
    cfg = config_from_dict(dict(d, m=fixed.shape[0], n_r=64))
    st = register(fixed.to(r["dev"]), moving.to(r["dev"]), ICPParams(alpha=2e2), cfg)
    cpu = register(fixed, moving, ICPParams(alpha=2e2), cfg)
    assert abs(int(st.k) - int(cpu.k)) <= 1
    assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.05
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.005
