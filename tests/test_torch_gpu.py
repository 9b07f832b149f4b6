"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; they skip where ``torch.cuda.is_available()`` is False.
The file imports neither jax nor the repo's conftest helpers, so on a
machine with a GPU and no jax it runs as

    python -m pytest tests/test_torch_gpu.py -m cuda --noconftest -q
"""

import importlib

import numpy as np
import pytest
import torch

from icp_tpu_torch.kernels import native
from icp_tpu_torch.sensors.synthetic import synthetic_pair
from icp_tpu_torch.sensors.brute_sets import ADVERSARIAL, adversarial
from icp_tpu_torch.sensors.knn_sets import ADVERSARIAL as KNN_ADVERSARIAL
from icp_tpu_torch.sensors.knn_sets import adversarial as knn_adversarial
from icp_tpu_torch.sensors.knn_sets import TOP2, top2
from icp_tpu_torch.sensors.search_sets import all_equal as search_all_equal

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
    fixed, moving = (torch.from_numpy(a).to(dev) for a in synthetic_pair(M))
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
    before = native.launches()
    rid, counts = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    rid_t, counts_t = fs.rep_assign_counts_ref(f["moving"], f["C"], f["srow"])
    torch.cuda.synchronize()
    assert (native.launches() - before)["rep_assign_counts"] == 1
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


def _k3_args(f, rid):
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin

    gl = group_rows_by_bin(rid, N_R, f["cfg"].query_capacity, (f["moving"],))
    return (gl.grouped[0], gl.valid.to(torch.float32), f["index"].reps,
            f["index"].bins_centered, f["index"].sq_b_masked.clone(), f["G"],
            f["b_row"], f["params"].alpha)


@pytest.mark.parametrize("case", ["masked_bin", "overfull_bin"])
def test_bin_point_moments_kernel_edge_bins(flagship, case):
    """K3 on a bin with every slot masked (+inf: its P is exactly 0) and on
    a bin holding more queries than its capacity (every query slot valid):
    within 1e-4 of max|P| of the twin's, and repeating bitwise."""
    from icp_tpu_torch.kernels import fused_step as fs

    f = flagship
    rid, _ = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    if case == "overfull_bin":
        rid = rid.clone()
        rid[:500] = 7
    args = _k3_args(f, rid)
    if case == "masked_bin":
        args[4][5] = float("inf")
    else:
        assert bool((args[1][7] == 1).all())
    P = fs.bin_point_moments(*args, weighted=True)
    P_t = fs.bin_point_moments_ref(*args, weighted=True)
    again = fs.bin_point_moments(*args, weighted=True)
    torch.cuda.synchronize()
    assert float((P - P_t).abs().max()) <= 1e-4 * float(P_t.abs().max())
    assert torch.equal(P, again)
    if case == "masked_bin":
        assert bool((P[5] == 0).all()) and bool((P_t[5] == 0).all())


@pytest.mark.parametrize("n_r, cq, cb", [(32, 768, 1024), (16, 1536, 2048),
                                         (8, 3072, 4096)])
def test_bin_point_moments_kernel_at_large_capacities(cuda_dev, n_r, cq, cb):
    """K3 on what the first fused POINT step of the flagship pair hands it
    with few, large bins, where the kernel walks several query tiles and
    (from cb 1024) several bin tiles: within 1e-4 of max|P| of the twin's,
    repeating bitwise."""
    from icp_tpu_torch import ICPConfig, ICPParams, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.rbc import search

    fixed, moving = (torch.from_numpy(a).to(cuda_dev) for a in synthetic_pair(M))
    cfg = ICPConfig(m=M, n_r=n_r)
    assert (cfg.query_capacity, cfg.bin_capacity) == (cq, cb)
    params = ICPParams(alpha=2e2).to(cuda_dev)
    seen = []
    real = search.bin_point_moments
    search.bin_point_moments = lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw)
    try:
        icp_step(identity_state(torch.float32, cuda_dev), moving,
                 build_index(fixed, params, cfg), params, cfg)
    finally:
        search.bin_point_moments = real
    a, kw = seen[0]
    got = fs.bin_point_moments(*a, **kw)
    want = fs.bin_point_moments_ref(*a, **kw)
    again = fs.bin_point_moments(*a, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)


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
    scene = synthetic.default_scene(device="cpu")
    q_b = torch.tensor([0.0, np.sin(0.004), 0.0, np.cos(0.004)], dtype=torch.float32)
    pose_b = synthetic.CameraPose(q_b, torch.tensor([10.0, -6.0, 8.0]))
    fixed, moving = (get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8))
                     .contiguous() for p in (synthetic.CameraPose.identity(device="cpu"), pose_b))
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


def _k4_step_args(dev, fixed, moving, cfg):
    """The arguments that the first robust-adaptive step hands K4."""
    from icp_tpu_torch import ICPParams, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.rbc import search

    params = ICPParams(alpha=2e2).to(dev)
    seen = []
    real = search.bin_min_dists
    search.bin_min_dists = lambda *a: seen.append(a) or real(*a)
    try:
        icp_step(identity_state(torch.float32, dev), moving,
                 build_index(fixed, params, cfg), params, cfg)
    finally:
        search.bin_min_dists = real
    return seen[0]


@pytest.mark.parametrize("case", ["rendered", "rendered plane_sym step", "n_r=256", "n_r=32",
                                  "n_r=16", "n_r=8", "all-equal 256", "all-equal 16",
                                  "all-equal 8"])
def test_bin_min_dists_kernel_matches_twin(rendered, case):
    """K4 against its twin, bitwise (the +inf set and every finite d2): on
    the rendered pair's first-iteration table (strided rows of the 11-wide
    grouped table) and on what a robust-adaptive symmetric-PLANE step hands
    it there (the 11-wide table again); on what robust-adaptive POINT steps
    of the flagship pair hand it at n_r 256, 32, 16 and 8 (cq up to 3072, cb up to 4096: several query and bin
    tiles in bounded shared memory); and on the all-equal bins of
    sensors/search_sets.py, where every partial minimum ties."""
    from icp_tpu_torch import ICPConfig, Objective, RobustKernel, Weighting
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.sensors.search_sets import ALPHA, min_dists_all_equal

    r = rendered
    dev = r["dev"]
    if case == "rendered":
        args = (r["mg"], r["qvalid"]) + r["search"]
    elif case == "rendered plane_sym step":
        args = _k4_step_args(dev, r["fixed_d"], r["moving_d"], ICPConfig(
            objective=Objective.PLANE, plane_symmetric=True, weighting=Weighting.REGULAR,
            robust=RobustKernel.TRIMMED, robust_adaptive=True, estimate_scale=False))
        assert args[0].stride(1) == 11  # lanes 0:8 of the 11-wide table
    elif case.startswith("n_r="):
        n_r = int(case[4:])
        fixed, moving = (torch.from_numpy(a).to(dev) for a in synthetic_pair(M))
        args = _k4_step_args(dev, fixed, moving, ICPConfig(
            n_r=n_r, robust=RobustKernel.HUBER, robust_adaptive=True))
        assert args[0].shape[0] == n_r
    else:
        n_r = int(case.split()[1])
        cq, cb = {256: (96, 128), 16: (1536, 2048), 8: (3072, 4096)}[n_r]
        args = tuple(torch.from_numpy(x).to(dev) for x in min_dists_all_equal(n_r, cq, cb))
        args += (ALPHA,)
    before = native.launches()
    got = fs.bin_min_dists(*args)
    want = fs.bin_min_dists_ref(*args)
    torch.cuda.synchronize()
    assert (native.launches() - before)["bin_min_dists"] == 1
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isfinite(want).any()) and bool(torch.isinf(want).any())


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
    before = native.launches()
    rid = fs.rep_assign(f["moving"], f["C"], f["srow"])
    rid_t = fs.rep_assign_ref(f["moving"], f["C"], f["srow"])
    rid_k1, _ = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    torch.cuda.synchronize()
    assert (native.launches() - before)["rep_assign"] == 1
    assert rid.dtype == torch.int32
    assert torch.equal(rid, rid_t) and torch.equal(rid, rid_k1)


def _search_tensors(dev, n_r, cq, cb, v, seed=0):
    """Weighted rep-centered queries and bins at bin-like magnitudes, ~30 %
    masked slots (+inf holes inside the bins), bin 1 empty (every slot
    +inf), bin 0 dead past a third of its slots (the kernel's live cut), and
    a V-wide payload."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w8 = torch.tensor([1, 1, 1, 0, 200, 200, 200, 0], dtype=torch.float32)
    qc = torch.randn(n_r, cq, 8, generator=g) * torch.tensor([40, 40, 40, 0, .3, .3, .3, 1])
    bins_c = torch.randn(n_r, cb, 8, generator=g) * torch.tensor([40, 40, 40, 0, .3, .3, .3, 1])
    sq_b = torch.sum(bins_c * w8 * bins_c, dim=-1)
    sq_b[torch.rand(n_r, cb, generator=g) < 0.3] = float("inf")
    sq_b[1] = float("inf")
    sq_b[0, cb // 3:] = float("inf")
    vals = torch.randn(n_r, cb, v, generator=g) * 1000
    return tuple(x.contiguous().to(dev) for x in (qc * w8, bins_c, sq_b, vals))


@pytest.mark.parametrize("n_r, cq, cb, v", [(256, 96, 128, 8), (256, 96, 128, 12),
                                            (32, 768, 1024, 8), (32, 768, 1024, 12),
                                            (16, 1536, 2048, 8), (16, 1536, 2048, 12),
                                            (8, 3072, 4096, 8), (8, 3072, 4096, 12),
                                            (3, 200, 700, 8), (5, 33, 9, 3)])
def test_bin_search_kernel_bitwise(cuda_dev, n_r, cq, cb, v):
    """K5 against its twin: the same scores and payloads bitwise, from the
    flagship capacities (cq 96, cb 128) to m 16384 over 32, 16 and 8 bins
    (cb up to 4096: several staged tiles per bin, without the
    large-shared-memory opt-in) and capacities off any tile size, with V 3
    taking the scalar payload copy."""
    # The module, not the wrapper the package exports under its name.
    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")

    args = _search_tensors(cuda_dev, n_r, cq, cb, v)
    before = native.launches()
    best, matched = bs.bin_search(*args)
    best_t, matched_t = bs.bin_search_ref(*args)
    torch.cuda.synchronize()
    assert (native.launches() - before)["bin_search"] == 1
    assert torch.equal(best.view(torch.int32), best_t.view(torch.int32))
    assert torch.equal(matched.view(torch.int32), matched_t.view(torch.int32))
    assert torch.isinf(best[1]).all() and torch.isfinite(matched).all()


@pytest.mark.parametrize("n_r, cq, cb, v", [(256, 96, 128, 8), (256, 96, 128, 12),
                                            (16, 1536, 2048, 8), (8, 3072, 4096, 12)])
def test_bin_search_kernel_all_equal_slots(cuda_dev, n_r, cq, cb, v):
    """K5 on bins whose live slots all hold one point (sensors/search_sets.py):
    every warp's partial minimum ties, within one staged tile (cb 128, three
    query slots a thread) and over several (cb 2048 and 4096, one a thread),
    and the (score, slot) merge must give the first live slot, bitwise the
    twin."""
    # The module, not the wrapper the package exports under its name.
    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")

    args = tuple(torch.from_numpy(x).to(cuda_dev) for x in search_all_equal(n_r, cq, cb, v))
    best, matched = bs.bin_search(*args)
    best_t, matched_t = bs.bin_search_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(best.view(torch.int32), best_t.view(torch.int32))
    assert torch.equal(matched.view(torch.int32), matched_t.view(torch.int32))
    live = torch.isfinite(args[2])
    first = torch.where(live.any(dim=1), live.int().argmax(dim=1), 0)
    want = args[3][torch.arange(n_r, device=cuda_dev), first]
    assert torch.equal(matched, want[:, None, :].expand(-1, cq, -1))


def test_bin_search_kernel_on_unfused_flagship_tables(flagship):
    """K5 on the grouped tables the unfused step builds at the flagship
    shape, bitwise against its twin."""
    # The module, not the wrapper the package exports under its name.
    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")
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
    # The module, not the wrapper the package exports under its name.
    bn = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

    q, db, w8 = _brute_tensors(cuda_dev, m, n)
    qw, db, sq_db = ((q * w8).to(cuda_dev), db.to(cuda_dev),
                     torch.sum(db * w8 * db, dim=-1).to(cuda_dev))
    before = native.launches()
    idx, score = bn.brute_nn(qw, db, sq_db)
    idx_t, score_t = bn.brute_nn_ref(qw, db, sq_db)
    torch.cuda.synchronize()
    assert (native.launches() - before)["brute_nn"] == 1
    assert torch.equal(idx, idx_t)
    assert torch.equal(score.view(torch.int32), score_t.view(torch.int32))


def test_brute_nn_kernel_planted_tie_picks_first(cuda_dev):
    """Duplicated database rows tie exactly: the first index wins, across
    stages of 256 rows."""
    # The module, not the wrapper the package exports under its name.
    bn = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

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


# ---- slice 5: K9 and K8, the kNN normals of unorganized clouds --------------


def _top2_case(name, dev):
    from icp_tpu_torch.ops.normals import _morton_order
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    if name in TOP2:
        p, reps = top2(name)
    else:
        m, n_r = {"wavy": (4096, 64), "16384": (16384, 128), "lidar": (262144, 2048)}[name]
        p = wavy_surface_pair(m)[0][:, :3].copy()
        stride = m // n_r
        order = _morton_order(torch.from_numpy(p)).numpy()
        reps = p[order[stride // 2::stride][:n_r]]
    return torch.from_numpy(p).to(dev), torch.from_numpy(np.ascontiguousarray(reps)).to(dev)


@pytest.mark.parametrize("name", ["normal", "ties", "split", "split wide", "wavy", "16384",
                                  "lidar"])
def test_rep_top2_counts_kernel_matches_twin(cuda_dev, name):
    """K9 against its twin from the reference test's data to the LiDAR shape
    (262144 raw points, 2048 Morton reps) and the GICP "knn_rbc" cell's
    16384 points (128 reps), and on the "split" sets, whose exact ties lie
    in different warps and chunks (4 and 8 points a thread): i1, i2 and the
    counts equal the twin's, and the counts are the bincounts of the
    kernel's own ids."""
    from icp_tpu_torch.kernels import knn_moments as km

    p, reps = _top2_case(name, cuda_dev)
    before = native.launches()
    got = km.rep_top2_counts(p, reps)
    want = km.rep_top2_counts_ref(p, reps)
    torch.cuda.synchronize()
    assert (native.launches() - before)["rep_top2_counts"] == 1
    n_r = reps.shape[0]
    for j in range(2):
        assert torch.equal(got[2][j], torch.bincount(got[j], minlength=n_r).to(torch.int32))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _knn_moment_tensors(dev, seed=0):
    """The reference test's K8 inputs: underfull bins and a NaN entry."""
    g = np.random.default_rng(seed)
    n_r, cq, cb = 8, 16, 128
    reps = (g.normal(size=(n_r, 3)) * 100).astype(np.float32)
    qp = reps[:, None, :] + (g.normal(size=(n_r, cq, 3)) * 40).astype(np.float32)
    bins = reps[:, None, :] + (g.normal(size=(n_r, cb, 3)) * 40).astype(np.float32)
    bvalid = np.ones((n_r, cb), bool)
    for r in range(n_r):
        bvalid[r, int(g.integers(4, cb)):] = False
    bins[2, 1] = np.nan
    qp[3, 5] = np.nan  # an invalid query: n = 1, C = 0
    return tuple(torch.from_numpy(x).to(dev) for x in (qp, bins, reps, bvalid))


def _check_knn_moments(args, k):
    """K8 against its twin: n bitwise, the components within 1e-5 of each
    query's largest, and a second launch bitwise equal to the first."""
    from icp_tpu_torch.kernels import knn_moments as km

    before = native.launches()
    comps, cnt = km.bin_knn_moments(*args, k=k)
    again = km.bin_knn_moments(*args, k=k)
    comps_t, cnt_t = km.bin_knn_moments_ref(*args, k=k)
    torch.cuda.synchronize()
    assert (native.launches() - before)["bin_knn_moments"] == 2
    assert torch.equal(cnt, cnt_t)
    got, want = torch.stack(comps), torch.stack(comps_t)
    scale = want.abs().amax(dim=0).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= 1e-5
    assert torch.equal(got.view(torch.int32), torch.stack(again[0]).view(torch.int32))
    assert torch.equal(cnt, again[1])
    return comps, cnt


def test_bin_knn_moments_kernel_matches_twin(cuda_dev):
    """K8 on the reference test's inputs: n bitwise, components within 1e-5
    of each query's largest component; the NaN query gives n = 1 and C = 0."""
    comps, cnt = _check_knn_moments(_knn_moment_tensors(cuda_dev), 12)
    assert float(cnt[3, 5]) == 1.0
    assert all(float(c[3, 5]) == 0.0 for c in comps)


def test_bin_knn_moments_kernel_at_the_lidar_shape(cuda_dev):
    """K8 on the tables the estimator builds at the LiDAR shape (262144
    points, n_r 2048, cq 192, cb 384, k 16), taken from its own call."""
    args, kw = _estimator_k8_args(cuda_dev, 262144)
    assert tuple(args[0].shape) == (2048, 192, 3) and tuple(args[1].shape) == (2048, 384, 3)
    _check_knn_moments(args, kw["k"])


def _estimator_k8_args(dev, m):
    """The (args, kwargs) that knn_normals_rbc hands K8 on the wavy surface
    of m points."""
    from icp_tpu_torch.ops import normals as nm
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    fixed = torch.from_numpy(wavy_surface_pair(m)[0]).to(dev)
    seen = []
    real = nm.bin_knn_moments
    nm.bin_knn_moments = lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw)
    try:
        nm.knn_normals_rbc(fixed)
    finally:
        nm.bin_knn_moments = real
    return seen[0]


def test_bin_knn_moments_kernel_at_the_16384_shape(cuda_dev):
    """K8 at the GICP "knn_rbc" cell's shape (16384 points: n_r 128, cq 192,
    cb 384, k 16), on the arguments the estimator hands it."""
    args, kw = _estimator_k8_args(cuda_dev, 16384)
    assert tuple(args[0].shape) == (128, 192, 3) and tuple(args[1].shape) == (128, 384, 3)
    _check_knn_moments(args, kw["k"])


@pytest.mark.parametrize("name", KNN_ADVERSARIAL)
def test_bin_knn_moments_kernel_on_adversarial_sets(cuda_dev, name):
    """K8 on sensors/knn_sets.py: ties at the k-th value, all-invalid bins,
    NaN queries, negative d2, k 1 / 12 / 16 / 40, cb 100 and 1024."""
    *arrays, k = knn_adversarial(name)
    _check_knn_moments(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda_dev)
                             for a in arrays), k)


@pytest.mark.parametrize("m, n_r, cap", [(16384, 256, 96), (262144, 2048, 256)])
def test_bin_table_gather_bitwise(cuda_dev, m, n_r, cap):
    """K2's gather form at the flagship and 16x layouts: the table from one
    to three unsorted sources (column slices among them) through the
    bin-major order, bitwise the twin of the gathered, concatenated rows
    (widths 8, 11, 12, 4 and 3)."""
    from icp_tpu_torch.kernels import table_build as tb
    from icp_tpu_torch.rbc.grouping import bin_sort_layout

    g = np.random.default_rng(0)
    ids = torch.from_numpy(g.integers(0, n_r, m).astype(np.int32)).to(cuda_dev)
    sidx, _, offsets, _ = bin_sort_layout(ids, n_r, cap)
    pts = torch.from_numpy(g.normal(size=(m, 8)).astype(np.float32)).to(cuda_dev)
    nrm = torch.from_numpy(g.normal(size=(m, 3)).astype(np.float32)).to(cuda_dev)
    col = torch.arange(m, dtype=torch.float32, device=cuda_dev)[:, None]
    before = native.launches()
    cases = [(pts,), (pts, nrm), (pts, col, nrm), (pts[:, :3], col), (pts[:, :3],)]
    for srcs in cases:
        got = tb.bin_table(srcs, offsets, capacity=cap, order=sidx)
        want = tb.bin_table_ref(tb.gathered_rows(srcs, sidx), offsets, capacity=cap)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (native.launches() - before)["bin_table"] == len(cases)


@pytest.fixture(scope="module")
def step16x(cuda_dev):
    """{wrapper name: (args, kwargs)} that the first LiDAR PLANE step (m
    262144, n_r 2048, normal_mode "knn") hands K1 and K7, and the first 16x
    POINT step hands K3."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.rbc import search
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    fixed, moving = (torch.from_numpy(a).to(cuda_dev) for a in wavy_surface_pair(262144)[:2])
    params = ICPParams(alpha=2e2).to(cuda_dev)
    st = identity_state(torch.float32, cuda_dev)
    seen = {}
    real = {n: getattr(search, n)
            for n in ("rep_assign_counts", "bin_gn_moments", "bin_point_moments")}

    def spy(name):
        def wrapped(*a, **kw):
            seen.setdefault(name, (a, kw))
            return real[name](*a, **kw)
        return wrapped

    for name in real:
        setattr(search, name, spy(name))
    try:
        for cfg in (ICPConfig(m=262144, n_r=2048, objective=Objective.PLANE,
                              estimate_scale=False, normal_mode="knn"),
                    ICPConfig(m=262144, n_r=2048)):
            icp_step(st, moving, build_index(fixed, params, cfg), params, cfg)
    finally:
        for name, fn in real.items():
            setattr(search, name, fn)
    return seen


def test_rep_assign_counts_kernel_at_the_16x_shape(step16x):
    """K1 at n_r 2048 (eight staged chunks of reps) on the LiDAR step's
    tensors: counts equal the bincount of its own rids and the twin's; every
    rid equal to the twin's (the same lane-order rounding)."""
    from icp_tpu_torch.kernels import fused_step as fs

    (moving8, C, srow), _ = step16x["rep_assign_counts"]
    assert tuple(C.shape) == (8, 2048)
    rid, counts = fs.rep_assign_counts(moving8, C, srow)
    rid_t, counts_t = fs.rep_assign_counts_ref(moving8, C, srow)
    torch.cuda.synchronize()
    assert torch.equal(counts, torch.bincount(rid, minlength=2048).to(torch.int32))
    assert torch.equal(rid, rid_t) and torch.equal(counts, counts_t)


def test_rep_assign_kernel_equals_k1_at_the_16x_shape(step16x):
    """K1′ (the kCounts = false instance) gives K1's rid at 262144 x 2048."""
    from icp_tpu_torch.kernels import fused_step as fs

    (moving8, C, srow), _ = step16x["rep_assign_counts"]
    rid1 = fs.rep_assign(moving8, C, srow)
    rid, _ = fs.rep_assign_counts(moving8, C, srow)
    torch.cuda.synchronize()
    assert torch.equal(rid1, rid)


def _k1_tensors(dev, m, n_r, planted=False):
    """K1's arguments for m moving rows of the synthetic pair against n_r of
    its fixed rows as reps (identity transform). With ``planted``, reps 7,
    40 and n_r - 1 are copies of rep 3 and rep n_r // 2 of rep n_r // 2 - 1
    (columns of C and srow copied exactly), and the first 64 rows sit on
    rep 3 and the next 64 on rep n_r // 2 - 1."""
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs

    fixed, moving = synthetic_pair(max(m, n_r), seed=3)
    g = np.random.default_rng(1)
    reps = torch.from_numpy(fixed[g.choice(fixed.shape[0], n_r, replace=False)])
    moving = torch.from_numpy(moving[:m].copy())
    st = identity_state(torch.float32, torch.device("cpu"))
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    C, srow = fs.prep_rep_assign(reps, torch.tensor(2e2), G, b_row)
    C, srow = C.contiguous(), srow.contiguous()
    if planted:
        h = n_r // 2
        for dst, src in ((7, 3), (40, 3), (n_r - 1, 3), (h, h - 1)):
            C[:, dst] = C[:, src]
            srow[0, dst] = srow[0, src]
        moving[:64] = reps[3]
        moving[64:128] = reps[h - 1]
    return moving.to(dev), C.to(dev), srow.to(dev)


@pytest.mark.parametrize("m, n_r, planted", [(4097, 300, False), (70001, 2000, False),
                                             (4097, 300, True), (16384, 2048, True)])
def test_rep_assign_counts_kernel_any_shape(cuda_dev, m, n_r, planted):
    """K1 and K1′ at shapes that are no multiple of any tile (queries per
    block, reps per stage), and with duplicated reps planted in different
    stages and warps' spans: rids equal to the twin's, the lower index
    winning every exact tie; counts exact."""
    from icp_tpu_torch.kernels import fused_step as fs

    moving, C, srow = _k1_tensors(cuda_dev, m, n_r, planted)
    rid, counts = fs.rep_assign_counts(moving, C, srow)
    rid1 = fs.rep_assign(moving, C, srow)
    rid_t, counts_t = fs.rep_assign_counts_ref(moving, C, srow)
    torch.cuda.synchronize()
    assert torch.equal(rid, rid_t) and torch.equal(counts, counts_t)
    assert torch.equal(rid1, rid)
    assert int(counts.sum()) == m
    if planted:
        assert (rid[:64] == 3).all() and (rid[64:128] == n_r // 2 - 1).all()


@pytest.mark.parametrize("name", ["bin_gn_moments", "bin_point_moments"])
def test_moment_kernels_at_the_16x_shape(step16x, name):
    """K7 plane (LiDAR step) and K3 (16x POINT step) at cq 192, cb 256:
    P within 1e-4 of max|P| of the twin's, repeating bitwise."""
    from icp_tpu_torch.kernels import fused_gn as fg
    from icp_tpu_torch.kernels import fused_step as fs

    kernel, twin = {"bin_gn_moments": (fg.bin_gn_moments, fg.bin_gn_moments_ref),
                    "bin_point_moments": (fs.bin_point_moments,
                                          fs.bin_point_moments_ref)}[name]
    a, kw = step16x[name]
    assert tuple(a[0].shape[:2]) == (2048, 192)
    got, want, again = kernel(*a, **kw), twin(*a, **kw), kernel(*a, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)


def test_knn_normals_rbc_on_card_matches_cpu(cuda_dev):
    """The RBC estimator at 16384 points on the card against the CPU twins:
    the same zero set, and |dn| <= 1e-4 on at least 99.9 % of the rows."""
    from icp_tpu_torch.ops.normals import knn_normals_rbc
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(16384)[0])
    cloud[::997] = 0.0  # dropouts
    got = knn_normals_rbc(cloud.to(cuda_dev)).cpu()
    want = knn_normals_rbc(cloud)
    assert torch.equal((got == 0).all(1), (want == 0).all(1))
    assert float(((got - want).abs().amax(1) <= 1e-4).float().mean()) >= 0.999


def test_plane_knn_register_on_card_matches_cpu(cuda_dev):
    """PLANE with kNN normals (brute at 4096 points, and RBC) on the card
    against the CPU twins, on the unorganized wavy-surface pair."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    fixed, moving = (torch.from_numpy(a) for a in wavy_surface_pair(4096)[:2])
    for mode in ("knn", "knn_rbc"):
        cfg = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE, normal_mode=mode,
                        estimate_scale=False)
        st = register(fixed.to(cuda_dev), moving.to(cuda_dev), ICPParams(alpha=2e2), cfg)
        cpu = register(fixed, moving, ICPParams(alpha=2e2), cfg)
        assert abs(int(st.k) - int(cpu.k)) <= 1
        assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.05
        assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.005


def test_knn_normals_rbc_reads_nothing_back(cuda_dev):
    """The RBC estimator on the card makes no call that waits for the
    stream (torch's sync debug mode raises on one), after a warm-up call
    that builds the kernels."""
    from icp_tpu_torch.ops.normals import knn_normals_rbc
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(16384)[0]).to(cuda_dev)
    knn_normals_rbc(cloud)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        knn_normals_rbc(cloud)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---- K6 as a tensor-core filter, K7 on K3's search, the step's host reads ---


def _brute_bitwise(qw, db, sq_db):
    """K6 against its twin: the same index on every query, the same score
    bitwise. Returns the pairs the kernel re-scored per query."""
    # The module, not the wrapper the package exports under its name.
    bn = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

    idx, score, rescored = bn.brute_nn(qw, db, sq_db, count_rescored=True)
    idx_t, score_t = bn.brute_nn_ref(qw, db, sq_db)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_t)
    assert torch.equal(score.view(torch.int32), score_t.view(torch.int32))
    assert bool((rescored >= 1).all()) and bool((rescored <= db.shape[0]).all())
    return rescored


@pytest.mark.parametrize("n", [7, 3001, 16391])
@pytest.mark.parametrize("m", [1, 17, 1000, 16385])
def test_brute_nn_filter_bitwise_off_every_tile(cuda_dev, m, n):
    """Query counts off the 128-query block and the 16-row tensor-core tile,
    database sizes off the 256-row stage and the 8-row tile."""
    q, db, w8 = _brute_tensors(cuda_dev, m, n, seed=2)
    _brute_bitwise((q * w8).to(cuda_dev), db.to(cuda_dev),
                   torch.sum(db * w8 * db, dim=-1).to(cuda_dev))


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_brute_nn_filter_bitwise_on_adversarial_sets(cuda_dev, name):
    """Uncentred +-1e4 mm coordinates, exact duplicates across stages,
    splits and quad lanes, equal-distance shells, scores 0-4 ulps apart."""
    _brute_bitwise(*(torch.from_numpy(a).to(cuda_dev) for a in adversarial(name)))


def test_brute_nn_filter_on_the_flagship_step(cuda_dev):
    """What the first BRUTE POINT step of the flagship pair hands K6 (16384 x
    16384): bitwise on every query, and a filter (few re-scored pairs)."""
    from icp_tpu_torch import Correspondence, ICPConfig, ICPParams, icp_step
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.ops import distance
    from icp_tpu_torch.runtime.support_sweep import capture
    from icp_tpu_torch.sensors.brute_sets import ALPHA

    fixed, moving = (torch.from_numpy(a).to(cuda_dev) for a in synthetic_pair(M))
    args, _ = capture(distance, "brute_nn", lambda: icp_step(
        identity_state(torch.float32, cuda_dev), moving, fixed,
        ICPParams(alpha=ALPHA).to(cuda_dev), ICPConfig(correspondence=Correspondence.BRUTE)))
    rescored = _brute_bitwise(*args).double()
    print(f"re-scored pairs per query: mean {float(rescored.mean())}, "
          f"max {int(rescored.max())}")
    assert float(rescored.mean()) <= 64


def _gn_step_args(dev, fixed, moving, cfg):
    """(args, kwargs) that the first fused GN step hands K7."""
    from icp_tpu_torch import ICPParams, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.rbc import search

    params = ICPParams(alpha=2e2).to(dev)
    seen = []
    real = search.bin_gn_moments
    search.bin_gn_moments = lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw)
    try:
        icp_step(identity_state(torch.float32, dev), moving,
                 build_index(fixed, params, cfg), params, cfg)
    finally:
        search.bin_gn_moments = real
    return seen[0]


@pytest.fixture(scope="module")
def gn_cases(cuda_dev, rendered):
    """K7's arguments from GICP steps (so the moving normals are there for
    every mode): the LiDAR shape (262144 x 2048, kNN normals; cq 192, cb
    256) and the rendered pair with few, large bins (n_r 32 / 16 / 8: cq up
    to 3072, cb up to 4096, several query and bin tiles)."""
    from icp_tpu_torch import ICPConfig, Objective
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cases = {}
    f16, m16 = (torch.from_numpy(a).to(cuda_dev) for a in wavy_surface_pair(262144)[:2])
    cases["16x"] = _gn_step_args(cuda_dev, f16, m16, ICPConfig(
        m=262144, n_r=2048, objective=Objective.GICP, estimate_scale=False,
        normal_mode="knn"))
    for n_r in (32, 16, 8):
        cases[f"n_r={n_r}"] = _gn_step_args(cuda_dev, rendered["fixed_d"], rendered["moving_d"],
                                            ICPConfig(n_r=n_r, objective=Objective.GICP,
                                                      estimate_scale=False))
    return cases


@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
@pytest.mark.parametrize("shape", ["16x", "n_r=32", "n_r=16", "n_r=8"])
def test_bin_gn_moments_kernel_at_step_shapes(gn_cases, shape, mode):
    """K7 in every mode and robust kind on what GN steps hand it: P (and
    P_z) within 1e-4 of max|P| of the twin's, repeating bitwise."""
    from icp_tpu_torch.kernels import fused_gn as fg

    a, kw = gn_cases[shape]
    a = (a[0], None if mode == "plane" else a[1]) + tuple(a[2:])
    for robust, weighted in (("none", True), ("huber", True), ("tukey", True),
                             ("trimmed", False)):
        kwr = dict(kw, mode=mode, weighted=weighted, robust=robust, robust_delta=12.0)
        got, want, again = (fg.bin_gn_moments(*a, **kwr), fg.bin_gn_moments_ref(*a, **kwr),
                            fg.bin_gn_moments(*a, **kwr))
        torch.cuda.synchronize()
        if mode != "gicp":
            got, want, again = (got,), (want,), (again,)
        for g, w, r in zip(got, want, again):
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), (robust, weighted)
            assert torch.equal(g, r)


STEP_CASES = ["brute_point", "plane", "gicp", "unfused_point", "unfused_plane", "fused_point",
              "robust_point", "robust_plane", "plane_sym", "unfused_gicp", "brute_plane"]


def _step_case(dev, rendered, case):
    """(fixed, moving, config) of a step path: BRUTE POINT, the unfused RBC
    POINT step, the fused POINT step (also with the SVD and Jacobi rotation
    solves) and POINT + HUBER + adaptive on the flagship pair; the fused
    PLANE, GICP and symmetric-PLANE steps, PLANE + TRIMMED + adaptive, the
    unfused PLANE and GICP steps and BRUTE PLANE on the rendered pair."""
    from icp_tpu_torch import (Correspondence, ICPConfig, Objective, RobustKernel,
                               RotationMode, Weighting)

    if case in ("brute_point", "unfused_point", "fused_point", "robust_point",
                "svd_point", "jacobi_point"):
        fixed, moving = (torch.from_numpy(a).to(dev) for a in synthetic_pair(M))
        cfg = {"brute_point": ICPConfig(correspondence=Correspondence.BRUTE),
               "unfused_point": ICPConfig(fused_point=False),
               "fused_point": ICPConfig(),
               "robust_point": ICPConfig(robust=RobustKernel.HUBER,
                                         robust_adaptive=True),
               "svd_point": ICPConfig(rotation=RotationMode.SVD),
               "jacobi_point": ICPConfig(rotation=RotationMode.JACOBI)}[case]
        return fixed, moving, cfg
    cfg = {"plane": ICPConfig(objective=Objective.PLANE, estimate_scale=False),
           "gicp": ICPConfig(objective=Objective.GICP, estimate_scale=False),
           "unfused_plane": ICPConfig(objective=Objective.PLANE, estimate_scale=False,
                                      fused_gn=False),
           "robust_plane": ICPConfig(objective=Objective.PLANE,
                                     weighting=Weighting.REGULAR,
                                     robust=RobustKernel.TRIMMED, robust_adaptive=True,
                                     estimate_scale=False),
           "plane_sym": ICPConfig(objective=Objective.PLANE, plane_symmetric=True,
                                  estimate_scale=False),
           "unfused_gicp": ICPConfig(objective=Objective.GICP, estimate_scale=False,
                                     fused_gn=False),
           "brute_plane": ICPConfig(objective=Objective.PLANE, estimate_scale=False,
                                    correspondence=Correspondence.BRUTE)}[case]
    return rendered["fixed_d"], rendered["moving_d"], cfg


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_chunk_reads_nothing_back(cuda_dev, rendered, case):
    """One 8-step chunk of icp_run makes no call that waits for the stream:
    torch's sync debug mode raises on one. On the flagship pair: BRUTE POINT
    (K6 and its margin), the unfused RBC POINT step (K5), the fused POINT
    step (K1, K2, K3) and POINT + HUBER + adaptive (K4 and the device
    median before K3). On the rendered pair: the fused PLANE, GICP and
    symmetric-PLANE steps (K7), PLANE + TRIMMED + adaptive (K4 and the
    median before K7), the unfused PLANE and GICP steps (K5) and BRUTE
    PLANE (K6). A first chunk builds the kernels."""
    from icp_tpu_torch import ICPParams, Objective, icp_step
    from icp_tpu_torch.icp.run import CHUNK, _select, build_target, converged
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.ops.normals import normals_for

    fixed, moving, cfg = _step_case(cuda_dev, rendered, case)
    params = ICPParams(alpha=2e2).to(cuda_dev)
    target = build_target(fixed, params, cfg)
    mn = (normals_for(moving, cfg.normal_mode)
          if cfg.objective is Objective.GICP or cfg.plane_symmetric else None)

    def chunk(state, done):
        for _ in range(CHUNK):
            take = torch.logical_and(state.k < cfg.max_iterations,
                                     torch.logical_or(state.k == 0, torch.logical_not(done)))
            new = icp_step(state, moving, target, params, cfg, moving_normals=mn)
            state = _select(take, new, state)
            done = torch.where(take, converged(new, params), done)
        return state, done

    state = identity_state(torch.float32, cuda_dev)
    done = torch.zeros((), dtype=torch.bool, device=cuda_dev)
    state, done = chunk(state, done)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, done = chunk(state, done)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(state.t).all())


# ---- the chunk as one CUDA graph ----------------------------------------------

STATE_FIELDS = ("q", "t", "s", "qk", "tk", "sk", "k")


def _eager_loop(movings, targets, params, cfg, inits, reads=True):
    """The chunked loop over lanes written out: 8 steps a chunk enqueued from
    Python, a lane frozen once its loop condition is false, and one host
    read of the condition a chunk (with ``reads=False`` every chunk that
    max_iterations allows). Returns each lane's state."""
    from icp_tpu_torch import icp_step
    from icp_tpu_torch.icp.run import CHUNK, _select, converged
    from icp_tpu_torch.icp.step import gn_mode
    from icp_tpu_torch.ops.normals import normals_for

    mns = [normals_for(m, cfg.normal_mode)
           if cfg.needs_normals and gn_mode(cfg) != "plane" else None for m in movings]
    states = list(inits)
    dones = [torch.zeros((), dtype=torch.bool, device=m.device) for m in movings]

    def running(state, done):
        return torch.logical_and(state.k < cfg.max_iterations,
                                 torch.logical_or(state.k == 0, torch.logical_not(done)))

    chunks = -(-cfg.max_iterations // CHUNK)
    while (bool(torch.stack([running(s, d) for s, d in zip(states, dones)]).any())
           if reads else chunks > 0):
        chunks -= 1
        for _ in range(CHUNK):
            for i, (moving, target, mn) in enumerate(zip(movings, targets, mns)):
                take = running(states[i], dones[i])
                new = icp_step(states[i], moving, target, params, cfg, moving_normals=mn)
                states[i] = _select(take, new, states[i])
                dones[i] = torch.where(take, converged(new, params), dones[i])
    return states


def _assert_states_equal(got, want, what=""):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), (what, name)


def _graph_counters():
    from icp_tpu_torch.runtime.timing import counters

    c = counters()
    return {name: c.get(name, 0) for name in ("icp.chunk_graph.captures",
                                              "icp.chunk_graph.replays", "icp.chunk_eager")}


def _counted(before):
    return {name: n - before[name] for name, n in _graph_counters().items()}


@pytest.mark.parametrize("case", STEP_CASES + ["svd_point", "jacobi_point"])
def test_icp_run_graph_equals_eager_chunk_loop(cuda_dev, rendered, case):
    """icp_run on every step path against the chunked loop written out by
    hand: q, t, s, qk, tk, sk and k torch.equal. Every chunk is a replay of
    one graph, captured once; the paths of EAGER_ROTATIONS (the SVD and
    Jacobi rotation solves) capture nothing and run every chunk eagerly. A
    second registration launches, wrapper by wrapper, what the loop written
    out launches."""
    from icp_tpu_torch import ICPParams
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.icp.run import build_target, chunk_captured, icp_run
    from icp_tpu_torch.icp.state import identity_state

    fixed, moving, cfg = _step_case(cuda_dev, rendered, case)
    params = ICPParams(alpha=2e2).to(cuda_dev)
    target = build_target(fixed, params, cfg)
    before = native.launches()
    (want,) = _eager_loop([moving], [target], params, cfg,
                          [identity_state(torch.float32, cuda_dev)])
    torch.cuda.synchronize()
    eager_launches = native.launches() - before
    chunk_graph.clear()
    before = _graph_counters()
    got = icp_run(moving, target, params, cfg)
    torch.cuda.synchronize()
    counted = _counted(before)
    chunks = counted["icp.chunk_graph.replays"] + counted["icp.chunk_eager"]
    assert chunks == -(-int(want.k) // 8)
    if case in ("svd_point", "jacobi_point"):
        assert not chunk_captured(cuda_dev, cfg)
        assert counted["icp.chunk_graph.captures"] == counted["icp.chunk_graph.replays"] == 0
    else:
        assert chunk_captured(cuda_dev, cfg)
        assert counted["icp.chunk_graph.captures"] == 1 and counted["icp.chunk_eager"] == 0
    _assert_states_equal(got, want, case)
    # Once captured, a registration replays every chunk: its launches by
    # wrapper are those of the loop written out.
    before = native.launches()
    again = icp_run(moving, target, params, cfg)
    torch.cuda.synchronize()
    assert native.launches() - before == eager_launches, case
    _assert_states_equal(again, want, case)


def test_chunk_graph_serves_successive_registrations(cuda_dev):
    """register of two flagship pairs (synthetic_pair seeds 0 and 1), then of
    the first with another alpha: one capture serves all three (the static
    buffers take each call's frames and params), each torch.equal to the
    loop written out. Another max_iterations is another key: a second
    capture, and the first key is still held."""
    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.icp.run import build_target
    from icp_tpu_torch.icp.state import identity_state

    chunk_graph.clear()
    before = _graph_counters()
    pairs = [tuple(torch.from_numpy(a).to(cuda_dev) for a in synthetic_pair(M, seed=s))
             for s in (0, 1)]
    calls = [(pairs[0], 2e2, ICPConfig()), (pairs[1], 2e2, ICPConfig()),
             (pairs[0], 1e2, ICPConfig()), (pairs[1], 2e2, ICPConfig(max_iterations=20)),
             (pairs[0], 2e2, ICPConfig())]
    results = []
    for (fixed, moving), alpha, cfg in calls:
        params = ICPParams(alpha=alpha)
        got = register(fixed, moving, params, cfg)
        params = params.to(cuda_dev)
        (want,) = _eager_loop([moving], [build_target(fixed, params, cfg)], params, cfg,
                              [identity_state(torch.float32, cuda_dev)])
        _assert_states_equal(got, want, (alpha, cfg.max_iterations))
        results.append(got)
    counted = _counted(before)
    assert counted["icp.chunk_graph.captures"] == 2 and counted["icp.chunk_eager"] == 0
    assert not torch.equal(results[0].t, results[1].t)  # the frames reached the graph
    _assert_states_equal(results[4], results[0], "the first key, replayed again")


def test_register_batch_graph_equals_eager_lanes(cuda_dev):
    """register_batch of three flagship pairs (seeds 0-2): one capture over
    three lanes, every lane torch.equal to the three-lane loop written
    out."""
    from icp_tpu_torch import ICPConfig, ICPParams, register_batch
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.icp.run import build_target
    from icp_tpu_torch.icp.state import identity_state

    pairs = [synthetic_pair(M, seed=s) for s in range(3)]
    fixed, moving = (torch.from_numpy(np.stack([p[i] for p in pairs])).to(cuda_dev)
                     for i in (0, 1))
    cfg, params = ICPConfig(), ICPParams(alpha=2e2)
    chunk_graph.clear()
    before = _graph_counters()
    batch = register_batch(fixed, moving, params, cfg)
    counted = _counted(before)
    params = params.to(cuda_dev)
    want = _eager_loop(list(moving), [build_target(f, params, cfg) for f in fixed], params,
                       cfg, [identity_state(torch.float32, cuda_dev) for _ in range(3)])
    assert counted["icp.chunk_graph.captures"] == 1 and counted["icp.chunk_eager"] == 0
    for i in range(3):
        _assert_states_equal(_lane(batch, i), want[i], i)


def _lane(batch, i):
    """Lane i of a batched ICPState."""
    from icp_tpu_torch.icp.state import ICPState

    return ICPState(**{name: getattr(batch, name)[i] for name in STATE_FIELDS})


def test_odometry_chain_graph_equals_eager_chain(cuda_dev, orbit_lms):
    """odometry_chain_device (icp_run with reads=False a pair) with its chunk
    captured inside sync debug mode's "error" window: nothing waits for the
    stream, capture included; one capture and a replay a pair; each frame's
    k and world pose torch.equal to the chain composed from the loop written
    out with reads=False."""
    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.icp.quaternion import qidentity, qmul, qnormalize, qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.slam.odometry import odometry_chain_device

    cfg = ICPConfig(max_iterations=8, estimate_scale=False)
    params = ICPParams(alpha=2e2).to(cuda_dev)
    q_w, t_w = qidentity(torch.float32, cuda_dev), torch.zeros(3, device=cuda_dev)
    want = []
    for i in range(orbit_lms.shape[0] - 1):
        index = build_index(orbit_lms[i].contiguous(), params, cfg)
        (st,) = _eager_loop([orbit_lms[i + 1].contiguous()], [index], params, cfg,
                            [identity_state(torch.float32, cuda_dev)], reads=False)
        q_w, t_w = qnormalize(qmul(q_w, st.q)), qrotate(q_w, st.t) + t_w
        want.append((q_w, t_w, st.k))
    chunk_graph.clear()
    torch.cuda.synchronize()
    before = _graph_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, t, ks = odometry_chain_device(orbit_lms, params, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = _counted(before)
    assert counted == {"icp.chunk_graph.captures": 1, "icp.chunk_eager": 0,
                       "icp.chunk_graph.replays": orbit_lms.shape[0] - 1}
    for i, (q_i, t_i, k_i) in enumerate(want):
        assert torch.equal(ks[i], k_i)
        assert torch.equal(q[i + 1], q_i) and torch.equal(t[i + 1], t_i)


# ---- slice 6: register_batch on the card -------------------------------------


@pytest.mark.parametrize("case", ["point", "brute", "plane"])
def test_register_batch_lanes_equal_register_on_card(cuda_dev, rendered, case):
    """register_batch at the flagship width against register of each pair on
    the card: every field of every lane torch.equal, k included (POINT and
    BRUTE POINT on synthetic_pair seeds 0-2, PLANE on the rendered pair and
    its copy with 12 % gross outliers); the lanes launch their kernels."""
    from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective,
                               register, register_batch)

    if case == "plane":
        rng = np.random.default_rng(5)
        dirty = rendered["moving"].numpy().copy()
        idx = rng.choice(dirty.shape[0], dirty.shape[0] // 8, replace=False)
        dirty[idx, :3] += rng.uniform(250, 500, (len(idx), 3)).astype(np.float32)
        fixed = torch.stack([rendered["fixed_d"]] * 2)
        moving = torch.stack([rendered["moving_d"], torch.from_numpy(dirty).to(cuda_dev)])
        cfg = ICPConfig(objective=Objective.PLANE, estimate_scale=False)
    else:
        pairs = [synthetic_pair(M, seed=s) for s in range(3)]
        fixed, moving = (torch.from_numpy(np.stack([p[i] for p in pairs])).to(cuda_dev)
                         for i in (0, 1))
        cfg = ICPConfig(correspondence=Correspondence.BRUTE if case == "brute"
                        else Correspondence.RBC)
    params = ICPParams(alpha=2e2)
    before = native.launches()
    batch = register_batch(fixed, moving, params, cfg)
    torch.cuda.synchronize()
    if case != "brute":
        assert ((native.launches() - before)["rep_assign_counts"]
                >= int(batch.k.max()) * fixed.shape[0])
    for i in range(fixed.shape[0]):
        single = register(fixed[i], moving[i], params, cfg)
        for name in ("q", "t", "s", "qk", "tk", "sk", "k"):
            assert torch.equal(getattr(batch, name)[i], getattr(single, name)), (i, name)


# ---- slice 7: the odometry chain, the frame stream, the guided filter -------


@pytest.fixture(scope="module")
def orbit_lms(cuda_dev):
    """Landmarks (16384 a frame) of three rendered frames of an orbit, made
    on the card."""
    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam.odometry import frame_to_landmarks

    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(3, radius_mm=30.0, yaw_rad=0.02)
    return torch.stack([frame_to_landmarks(synthetic.render_cloud(scene, p)) for p in poses])


@pytest.mark.parametrize("objective", ["gicp", "point"])
def test_odometry_chain_reads_nothing_and_equals_icp_run(cuda_dev, orbit_lms, objective):
    """odometry_chain_device at the flagship width under sync debug mode
    (no call waits for the stream), and each frame's k and world pose
    torch.equal to icp_run's state with reads, composed on the card."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective
    from icp_tpu_torch.icp.quaternion import qmul, qnormalize, qrotate
    from icp_tpu_torch.icp.run import build_index, icp_run
    from icp_tpu_torch.slam.odometry import odometry_chain_device

    cfg = ICPConfig(max_iterations=8, estimate_scale=False, objective=Objective(objective))
    params = ICPParams(alpha=2e2).to(cuda_dev)
    odometry_chain_device(orbit_lms, params, cfg)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, t, ks = odometry_chain_device(orbit_lms, ICPParams(alpha=2e2), cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    q_w, t_w = q[0], t[0]
    for i in range(2):
        st = icp_run(orbit_lms[i + 1].contiguous(),
                     build_index(orbit_lms[i].contiguous(), params, cfg), params, cfg)
        q_w, t_w = qnormalize(qmul(q_w, st.q)), qrotate(q_w, st.t) + t_w
        assert torch.equal(ks[i], st.k)
        assert torch.equal(q[i + 1], q_w) and torch.equal(t[i + 1], t_w)


def test_frame_source_native_ring(cuda_dev, tmp_path):
    """The native prefetch ring streams the frames bitwise."""
    from icp_tpu_torch.runtime import native
    from icp_tpu_torch.sensors.stream import FrameSource

    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(640 * 480, 8)).astype(np.float32) for _ in range(3)]
    for i, f in enumerate(frames):
        native.write_cloud(str(tmp_path / f"f{i}.bin"), f)
    with FrameSource(str(tmp_path)) as src:
        assert src.native
        got = list(src)
    assert [i for i, _ in got] == [0, 1, 2]
    assert all(np.array_equal(g, f) for (_, g), f in zip(got, frames))


def test_guided_filter_on_card_matches_cpu(cuda_dev):
    """filter_depth within 1 mm and filter_rgb within 1e-4 of the CPU on a
    640 x 480 render (float32 cumsums summed in another order); invalid
    depth stays 0."""
    from icp_tpu_torch.sensors import guided_filter as gf
    from icp_tpu_torch.sensors import synthetic

    depth, rgb = synthetic.render(synthetic.default_scene(device="cpu"),
                                  synthetic.CameraPose.identity(device="cpu"))
    depth[100:140, 200:260] = 0.0
    dd = gf.filter_depth(depth.to(cuda_dev)).cpu()
    dc = gf.filter_depth(depth)
    assert torch.equal(dd == 0, depth == 0)
    assert float((dd - dc).abs().max()) <= 1.0
    assert float((gf.filter_rgb(rgb.to(cuda_dev)).cpu() - gf.filter_rgb(rgb)).abs().max()) <= 1e-4


def _no_host_read(fn):
    """``fn()`` with any call that waits for the stream an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("solver, n", [("optimize", 96), ("optimize_pcg", 600)])
def test_pose_graph_solvers_read_nothing_and_repeat(cuda_dev, solver, n):
    """The LM loops enqueue with no host read, repeat bit for bit (no
    floating-point atomics in the assembly), and land where the CPU lands
    within tests/test_torch_pose_graph.py's ring tolerances."""
    from icp_tpu_torch.slam import pose_graph as pg

    fn = getattr(pg, solver)
    g = pg.demo_ring_graph(n, device=cuda_dev)
    a = _no_host_read(lambda: fn(g, iterations=10))
    b = _no_host_read(lambda: fn(g, iterations=10))
    assert torch.equal(a.q, b.q) and torch.equal(a.t, b.t)
    c = fn(pg.PoseGraph(*(x.cpu() for x in g)), iterations=10)
    assert float((a.t.cpu() - c.t).abs().max()) <= 2.0
    assert float((a.q.cpu() - c.q).abs().max()) <= 5e-3
    ca, cc = float(pg.graph_cost(a)), float(pg.graph_cost(c))
    assert abs(ca - cc) <= 1e-2 * cc and ca < 0.05 * float(pg.graph_cost(g))


def test_ba_solve_reads_nothing_and_repeats(cuda_dev):
    """After its host degree check, ba_solve enqueues with no host read,
    repeats bit for bit and lands where the CPU lands (within 1e-3 mm)."""
    from icp_tpu_torch.slam import bundle_adjustment as ba

    prob = ba.demo_problem(32, 4096, 8, device=cuda_dev)
    assert ba.check_max_degree(prob.obs_point, 4096, 8) <= 8
    a = _no_host_read(lambda: ba._ba_solve(prob, 5, 8, 1e-4, True))
    b = _no_host_read(lambda: ba._ba_solve(prob, 5, 8, 1e-4, True))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ba.ba_solve(ba.BAProblem(*(x.cpu() for x in prob)), 5)
    assert float((a.pose_t.cpu() - c.pose_t).abs().max()) <= 1e-3
    assert float((a.points.cpu() - c.points).abs().max()) <= 1e-3
    assert float(ba.ba_cost(a)) < 0.01 * float(ba.ba_cost(prob))


def test_slam_engine_on_card_matches_cpu(cuda_dev):
    """A 5-frame there-and-back loop (every frame a keyframe; the loop
    closes at the start) on the card and on the CPU: the same keyframes,
    edges and closures, poses within the slice tolerances composed along
    the chain (0.05 mm, 1e-5), and after optimize_map within 1 mm and
    2e-2 in q (tests/test_torch_slam_engine.py)."""
    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.icp.pyramid import subsample_grid
    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam.mapping import LoopClosureConfig, SlamEngine
    from icp_tpu_torch.slam.odometry import KeyframePolicy, frame_to_landmarks

    scene = synthetic.default_scene(device="cpu")
    lms = []
    for i in range(5):
        back = 1.0 - abs(2 * i / 4 - 1.0)
        q = torch.tensor([0.0, np.sin(0.005 * back), 0.0, np.cos(0.005 * back)],
                         dtype=torch.float32)
        pose = synthetic.CameraPose(q, torch.tensor([40.0 * back, 0.0, 25.0 * back]))
        lms.append(subsample_grid(frame_to_landmarks(synthetic.render_cloud(scene, pose)), 2))

    def run(dev):
        eng = SlamEngine(ICPParams(alpha=2e2),
                         ICPConfig(m=4096, n_r=64, estimate_scale=False, max_iterations=40),
                         policy=KeyframePolicy(max_gap=1),
                         loop_config=LoopClosureConfig(min_gap=3, max_distance=100.0))
        for f in lms:
            eng.process_frame(f.to(dev))
        before = [(p.q.cpu(), p.t.cpu()) for p in eng.trajectory]
        eng.optimize_map(iterations=5)
        return eng, before

    (eg, bg), (ec, bc) = run(cuda_dev), run("cpu")
    assert eg.map.edges == ec.map.edges and eg.map.loop_closures == ec.map.loop_closures
    assert len(eg.map.loop_closures) >= 1
    for (qg, tg), (qc, tc) in zip(bg, bc):
        assert float((tg - tc).abs().max()) <= 0.05 and float((qg - qc).abs().max()) <= 1e-5
    for kg, kc in zip(eg.map.keyframes, ec.map.keyframes):
        assert kg.pose.t.device.type == "cuda"
        assert float((kg.pose.t.cpu() - kc.pose.t).abs().max()) <= 1.0
        assert float((kg.pose.q.cpu().abs() - kc.pose.q.abs()).abs().max()) <= 2e-2


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_sharded_register_world_on_card(cuda_dev, mesh, tmp_path):
    """A world of 2 ranks sharing the card (gloo carries the CUDA tensors)
    runs make_sharded_register at m 4096, n_r 64 on the synthetic pair:
    POINT (K2 and K3 every step) and POINT + HUBER with the adaptive scale
    (K2 and K5, the distributed median). Both ranks end bitwise equal, and
    near the card's own register: tests/test_sharded.py's bars (0.1 mm and
    5e-3 deg for POINT, 0.5 mm and 0.05 deg for the robust run)."""
    from icp_tpu_torch import ICPConfig, ICPParams, RobustKernel, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.parallel.dryrun import launch_world

    native.load_library()  # built here: the ranks load it and never compile
    fixed, moving = (torch.from_numpy(a) for a in synthetic_pair(4096))
    params = ICPParams(alpha=2e2)
    cases = {"point": (ICPConfig(m=4096, n_r=64), "bin_point_moments", (0.1, 5e-3)),
             "robust": (ICPConfig(m=4096, n_r=64, robust=RobustKernel.HUBER,
                                  robust_adaptive=True), "bin_search", (0.5, 0.05))}
    res = launch_world({"mesh": mesh, "device": "cuda", "tasks": [
        dict(kind="register", name=name, config=config, params=params, fixed=fixed,
             moving=moving) for name, (config, _, _) in cases.items()]},
        2, tmp_path, timeout=180.0, init_timeout=60.0)
    for name, (config, kernel, (t_bar, a_bar)) in cases.items():
        a, b = (r["tasks"][name] for r in res)
        assert all(torch.equal(a["out"][k], b["out"][k]) for k in a["out"]), name
        k = int(a["out"]["k"])
        for ran in (a["launches"], b["launches"]):
            assert ran["bin_table"] >= k + 1 and ran[kernel] >= k, (name, ran)
        ref = register(fixed.to(cuda_dev), moving.to(cuda_dev), params, config)
        assert float((a["out"]["t"] - ref.t.cpu()).norm()) < t_bar, name
        assert float(qangle_deg(qmul(a["out"]["q"], qconj(ref.q.cpu())))) < a_bar, name


# ---- slice 10: the examples ---------------------------------------------------


def test_registration_example_on_card(cuda_dev, tmp_path):
    """``registration --synthetic`` through its ``main(argv)`` on the card:
    the rendered gate pair (0.008 rad about y, t (10, -6, 8) mm) within
    10 mm and 0.3 deg (POINT's landmark-lattice floor), K1, K2 and K3
    launched every step."""
    from icp_tpu_torch.examples import registration
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    before = native.launches()
    st = registration.main(["--synthetic", "--out-dir", str(tmp_path)])
    ran = native.launches() - before
    k = int(st.k)
    assert st.t.device.type == "cuda" and 1 <= k < 40
    q_b = torch.tensor([0.0, np.sin(0.004), 0.0, np.cos(0.004)], dtype=torch.float32)
    assert float(torch.linalg.vector_norm(st.t.cpu().double() - torch.tensor(
        [10.0, -6.0, 8.0], dtype=torch.float64))) < 10.0
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(q_b)))) < 0.3
    kernels = ("rep_assign_counts", "bin_table", "bin_point_moments")
    assert all(ran[name] >= k for name in kernels), ran
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fixed.ply", "registered.ply"]


# ---- slice 11: launches past the shared-memory size of a block ----------------


def test_rep_top2_counts_at_n_r_32768(cuda_dev):
    """K9 at the estimator's automatic n_r of 2^21 + 128 points (32768),
    where its 2 x n_r count histogram no longer fits in shared memory: i1,
    i2 and counts bitwise the twin's, the counts the bincounts of its ids."""
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.runtime.support_sweep import capture
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(2 ** 21 + 128)[0]).to(cuda_dev)
    p3, reps = capture(normals_mod, "rep_top2_counts",
                       lambda: normals_mod.knn_normals_rbc(cloud))[0]
    assert reps.shape[0] == 32768
    got = km.rep_top2_counts(p3, reps)
    want = km.rep_top2_counts_ref(p3, reps, chunk=2048)
    torch.cuda.synchronize()
    for j in range(2):
        assert torch.equal(got[2][j], km.bin_counts(got[j], 32768))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_knn_normals_rbc_on_2m_points(cuda_dev):
    """knn_normals_rbc on 2^21 + 128 points (K9 at n_r 32768) against the
    same estimator with K9 and K8 swapped for their twins: the same zero
    set, median |cos| > 0.999."""
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(2 ** 21 + 128)[0]).to(cuda_dev)
    n_k = normals_mod.knn_normals_rbc(cloud)
    orig = normals_mod.rep_top2_counts, normals_mod.bin_knn_moments
    normals_mod.rep_top2_counts = lambda p, r: km.rep_top2_counts_ref(p, r, chunk=2048)
    normals_mod.bin_knn_moments = km.bin_knn_moments_ref
    try:
        n_t = normals_mod.knn_normals_rbc(cloud)
    finally:
        normals_mod.rep_top2_counts, normals_mod.bin_knn_moments = orig
    nonzero = n_t.norm(dim=-1) > 0
    assert torch.equal(n_k.norm(dim=-1) > 0, nonzero)
    assert float((n_k * n_t).sum(-1).abs()[nonzero].median()) > 0.999


def test_bin_knn_moments_at_cb_6144(cuda_dev):
    """K8 on what knn_normals_rbc(n_r=128) hands it on a 262144-point sweep
    (cq 3072, cb 6144: its arrays in the global workspace): n bitwise, the
    components within 1e-5 of each query's largest, repeating bitwise."""
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.runtime.support_sweep import capture
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(262144)[0]).to(cuda_dev)
    args, kw = capture(normals_mod, "bin_knn_moments",
                       lambda: normals_mod.knn_normals_rbc(cloud, n_r=128))
    assert (args[0].shape[1], args[1].shape[1]) == (3072, 6144)
    comps, cnt = km.bin_knn_moments(*args, **kw)
    again = km.bin_knn_moments(*args, **kw)
    comps_t, cnt_t = km.bin_knn_moments_ref(*args, **dict(kw, chunk=2))
    torch.cuda.synchronize()
    ck, ct = torch.stack(comps), torch.stack(comps_t)
    assert torch.equal(cnt, cnt_t)
    assert float(((ck - ct).abs() / ct.abs().amax(dim=0).clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(ck, torch.stack(again[0])) and torch.equal(cnt, again[1])


def test_rep_assign_counts_at_n_r_65536(cuda_dev):
    """K1 and K1' at n_r 65536 on 262144 rows, where K1's count histogram no
    longer fits in shared memory: every rid the twin's, the counts exact."""
    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.ops.sampling import sample_representative_indices

    cfg = ICPConfig(m=262144, n_r=65536)
    fixed, moving = (torch.from_numpy(a).to(cuda_dev) for a in synthetic_pair(cfg.m))
    reps = fixed[sample_representative_indices(cfg.m, cfg.n_r, cfg.rep_grid,
                                               device=cuda_dev).long()]
    st = identity_state(torch.float32, cuda_dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    C, srow = fs.prep_rep_assign(reps, torch.full((), 2e2, device=cuda_dev),
                                 G.contiguous(), b_row)
    C = C.contiguous()
    rid, counts = fs.rep_assign_counts(moving, C, srow)
    rid1 = fs.rep_assign(moving, C, srow)
    rid_t = torch.cat([fs.rep_assign_ref(moving[s:s + 256], C, srow)
                       for s in range(0, cfg.m, 256)])
    torch.cuda.synchronize()
    assert torch.equal(rid, rid_t) and torch.equal(rid1, rid)
    assert torch.equal(counts, torch.bincount(rid_t, minlength=cfg.n_r).to(torch.int32))


def test_bin_knn_moments_past_the_grid_limit(cuda_dev):
    """K8 on what knn_normals_rbc(n_r=2) hands it on 174768 points (cq
    131080, cb 262160): more query tiles of the shared-memory grid than its
    second dimension holds, so the workspace path runs it. Against the twin
    on query slices at the start, across the first span boundary and at the
    end (the queries are independent): n bitwise, the components within
    1e-5 of each query's largest."""
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.runtime.support_sweep import capture
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(174768)[0]).to(cuda_dev)
    (qp, bins, reps, bvalid), kw = capture(
        normals_mod, "bin_knn_moments", lambda: normals_mod.knn_normals_rbc(cloud, n_r=2))
    cq = qp.shape[1]
    assert (cq, bins.shape[1]) == (131080, 262160)
    comps, cnt = km.bin_knn_moments(qp, bins, reps, bvalid, **kw)
    ck = torch.stack(comps)
    for s in (0, 14576 - 256, cq - 512):
        comps_t, cnt_t = km.bin_knn_moments_ref(qp[:, s:s + 512], bins, reps, bvalid,
                                                **dict(kw, chunk=1))
        ct = torch.stack(comps_t)
        assert torch.equal(cnt[:, s:s + 512], cnt_t), s
        rel = (ck[:, :, s:s + 512] - ct).abs() / ct.abs().amax(dim=0).clamp(min=1e-30)
        assert float(rel.max()) <= 1e-5, s


def test_launch_limits_raise_before_launch(cuda_dev):
    """A shape past a launch limit left after the repairs raises a
    ValueError from the C launch code that names the limit and the shape,
    and launches nothing: K2's rows of 456 lanes (shared memory), K2's
    capacity and K5's query tiles past the grid's second dimension."""
    from icp_tpu_torch.kernels import table_build as tb

    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")
    starts = torch.zeros((1,), dtype=torch.int32, device=cuda_dev)
    before = native.launches()
    with pytest.raises(ValueError, match="shared memory"):
        tb.bin_table(torch.zeros((4, 456), device=cuda_dev), starts, capacity=4)
    with pytest.raises(ValueError, match="second dimension"):
        tb.bin_table(torch.zeros((4, 3), device=cuda_dev), starts, capacity=128 * 65535 + 1)
    cq, cb = 65535 * 32 + 1, 513
    args = (torch.zeros((1, cq, 8), device=cuda_dev), torch.zeros((1, cb, 8), device=cuda_dev),
            torch.zeros((1, cb), device=cuda_dev), torch.zeros((1, cb, 8), device=cuda_dev))
    with pytest.raises(ValueError, match="second dimension"):
        bs.bin_search(*args)
    assert native.launches() == before
